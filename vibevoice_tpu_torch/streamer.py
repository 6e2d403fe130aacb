"""Audio streaming delivery: per-sample queues bridging the generation loop
to consumers (UI / server / file writer).

API-compatible re-implementation of the reference's AudioStreamer /
AsyncAudioStreamer (reference vibevoice/modular/streamer.py:13-264) operating
on numpy arrays (the generation engine hands over host arrays once per frame).
The port's own copy of vibevoice_tpu/streamer.py.
"""

from __future__ import annotations

import asyncio
import queue
import time
from typing import Iterable, List, Optional

import numpy as np


class AudioStreamer:
    """Synchronous multi-sample streamer (reference streamer.py:13-86)."""

    def __init__(self, batch_size: int, stop_signal=None, timeout: Optional[float] = None):
        self.batch_size = batch_size
        self.stop_signal = stop_signal
        self.timeout = timeout
        self.audio_queues: List[queue.Queue] = [queue.Queue() for _ in range(batch_size)]
        self.finished_flags = [False] * batch_size
        self.sample_indices_map = {i: i for i in range(batch_size)}

    def put(self, audio_chunks, sample_indices) -> None:
        """Push one frame of audio per listed sample.

        audio_chunks: array-like (N, samples) or list of 1-D arrays;
        sample_indices: iterable of N sample ids.
        """
        for chunk, idx in zip(audio_chunks, np.asarray(sample_indices).tolist()):
            if idx >= self.batch_size or self.finished_flags[idx]:
                continue
            self.audio_queues[idx].put(np.asarray(chunk), timeout=self.timeout)

    def end(self, sample_indices: Optional[Iterable[int]] = None) -> None:
        """Signal end of stream for given samples (or all)."""
        indices = (
            range(self.batch_size)
            if sample_indices is None
            else np.asarray(sample_indices).reshape(-1).tolist()
        )
        for idx in indices:
            if idx < self.batch_size and not self.finished_flags[idx]:
                self.finished_flags[idx] = True
                self.audio_queues[idx].put(self.stop_signal, timeout=self.timeout)

    def get_stream(self, sample_idx: int) -> "AudioSampleIterator":
        return AudioSampleIterator(self, sample_idx)

    def __iter__(self):
        return AudioBatchIterator(self)


class AudioSampleIterator:
    """Iterate one sample's chunks until its stop signal (reference :89-116)."""

    def __init__(self, streamer: AudioStreamer, sample_idx: int):
        self.streamer = streamer
        self.sample_idx = sample_idx

    def __iter__(self):
        return self

    def __next__(self):
        value = self.streamer.audio_queues[self.sample_idx].get(timeout=self.streamer.timeout)
        if value is self.streamer.stop_signal:
            raise StopIteration()
        return value


class AudioBatchIterator:
    """Round-robin over all live samples; yields (sample_idx, chunk)
    (reference :119-147)."""

    POLL_INTERVAL = 0.01

    def __init__(self, streamer: AudioStreamer):
        self.streamer = streamer
        self.active = set(range(streamer.batch_size))

    def __iter__(self):
        return self

    def __next__(self):
        while self.active:
            for idx in sorted(self.active):
                try:
                    value = self.streamer.audio_queues[idx].get_nowait()
                except queue.Empty:
                    continue
                if value is self.streamer.stop_signal:
                    self.active.discard(idx)
                    continue
                return idx, value
            time.sleep(self.POLL_INTERVAL)
        raise StopIteration()


class AsyncAudioStreamer:
    """Asyncio variant: producer thread pushes via call_soon_threadsafe
    (reference :150-264)."""

    def __init__(self, batch_size: int, stop_signal=None, loop: Optional[asyncio.AbstractEventLoop] = None):
        self.batch_size = batch_size
        self.stop_signal = stop_signal
        self.loop = loop or asyncio.get_event_loop()
        self.audio_queues: List[asyncio.Queue] = [asyncio.Queue() for _ in range(batch_size)]
        self.finished_flags = [False] * batch_size

    def _put_threadsafe(self, idx: int, value) -> None:
        self.loop.call_soon_threadsafe(self.audio_queues[idx].put_nowait, value)

    def put(self, audio_chunks, sample_indices) -> None:
        for chunk, idx in zip(audio_chunks, np.asarray(sample_indices).tolist()):
            if idx >= self.batch_size or self.finished_flags[idx]:
                continue
            self._put_threadsafe(idx, np.asarray(chunk))

    def end(self, sample_indices: Optional[Iterable[int]] = None) -> None:
        indices = (
            range(self.batch_size)
            if sample_indices is None
            else np.asarray(sample_indices).reshape(-1).tolist()
        )
        for idx in indices:
            if idx < self.batch_size and not self.finished_flags[idx]:
                self.finished_flags[idx] = True
                self._put_threadsafe(idx, self.stop_signal)

    async def get_stream(self, sample_idx: int):
        while True:
            value = await self.audio_queues[sample_idx].get()
            if value is self.stop_signal:
                return
            yield value
