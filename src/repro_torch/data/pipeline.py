"""Synthetic data streams with host prefetch (port of
``repro.data.pipeline``).

Deterministic by construction: batch ``i`` is a pure function of
``(seed, i)``, so a restart resumes the stream exactly from the step
counter a checkpoint stores.  Both generators draw with numpy's
``default_rng((seed, step))`` in the reference's order, so their batches
equal the reference's bit for bit:

* :class:`TokenStream` — LM batches with a Zipf token marginal, in the
  port's :func:`~repro_torch.models.api.batch_schema`;
* :class:`ClimateStream` — DeepCAM-style (image, label) pairs: smooth
  fields (low-resolution noise repeated 8×8) and rare-class labels where
  channel 0 is extreme.

Batches are numpy arrays.  :class:`Prefetcher` keeps ``prefetch`` of
them ready on a background thread, each passed through an optional
``transform``; :func:`to_device` is the transform that puts a batch on
the card.  What overlaps with the training step and what does not:

* the batch's generation (numpy) and the copy into pinned host memory
  run on the prefetch thread while the main thread waits for the card;
* the host-to-device copy is issued ``non_blocking`` from the pinned
  buffer, but on the legacy default stream, which every host thread
  shares: the copy queues behind the step's kernels already on it and
  the next step's kernels queue behind the copy.  The copy's DMA does
  not overlap compute; it only keeps the host from waiting for it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.api import batch_schema


class TokenStream:
    """Deterministic synthetic LM batches matching ``batch_schema``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, batch: int,
                 seed: int = 0):
        self.cfg, self.shape, self.batch, self.seed = cfg, shape, batch, seed
        self.schema = batch_schema(cfg, shape, batch)
        # Zipf marginal over the vocab (deterministic ranks)
        v = max(cfg.vocab_size, 2)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def __call__(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        out: dict[str, np.ndarray] = {}
        for name, (shp, dt) in self.schema.items():
            if name in ("tokens", "targets"):
                continue
            if dt.is_floating_point:
                out[name] = (rng.standard_normal(shp) * 0.02).astype(
                    np.float32)
            else:
                out[name] = rng.integers(0, 2, shp).astype(np.int32)
        if "tokens" in self.schema:
            (b, s), _ = self.schema["tokens"]
            seq = rng.choice(len(self._probs), size=(b, s + 1),
                             p=self._probs).astype(np.int32)
            out["tokens"] = seq[:, :-1]
            out["targets"] = seq[:, 1:]
        return out


class ClimateStream:
    """DeepCAM-style synthetic climate images + segmentation labels."""

    def __init__(self, hw: tuple[int, int], batch: int, channels: int = 16,
                 n_classes: int = 3, seed: int = 0):
        self.hw, self.batch, self.channels = hw, batch, channels
        self.n_classes, self.seed = n_classes, seed

    def __call__(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        H, W = self.hw
        # smooth fields: low-res noise upsampled (cheap spatial correlation)
        low = rng.standard_normal(
            (self.batch, max(H // 8, 1), max(W // 8, 1), self.channels))
        img = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)[:, :H, :W, :]
        img = img.astype(np.float32)
        # labels: rare classes where channel-0 anomaly is extreme
        a = img[..., 0]
        lab = np.zeros((self.batch, H, W), np.int32)
        lab[a > 1.2] = 1          # "tropical cyclone"
        lab[a < -1.2] = 2         # "atmospheric river"
        return {"images": img, "labels": lab}


def to_device(device: str | torch.device
              ) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """The transform that puts a batch of numpy arrays (or tensors) on
    ``device``: on a CUDA device each host array is copied into pinned
    memory and sent with a non-blocking copy (see the module doc for what
    that overlaps); on the host the tensors share the arrays' memory."""
    device = torch.device(device)

    def put(batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v)))
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t.to(device)
        return out

    return put


class Prefetcher:
    """Background-thread prefetch of ``make_batch(step)`` results, in step
    order from ``start_step``."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int = 0,
                 prefetch: int = 2,
                 transform: Callable[[Any], Any] | None = None):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._transform = transform or (lambda x: x)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._transform(self._make(step))
            except Exception as e:                  # re-raised by next()
                batch = _Failed(e)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, _Failed):
                return
            step += 1

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        while True:
            yield self.next()

    def next(self) -> tuple[int, Any]:
        step, batch = self._q.get()
        if isinstance(batch, _Failed):
            raise batch.error
        return step, batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class _Failed:
    """A ``make_batch`` or ``transform`` error, carried to the consumer."""

    def __init__(self, error: Exception):
        self.error = error
