"""Command-line demos of the port: file inference for the multi-speaker and
the streaming models."""
