"""Fine-tuning of the PyTorch port: training loss, LoRA / QLoRA adapters,
optimizer and steps, EMA, data collation and the CLI
(port of vibevoice_tpu/finetune/)."""
