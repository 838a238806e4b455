"""Data-parallel decode serving: engine replicas behind one least-busy
front (port of ``legalrag_tpu/parallel/decoder_dp.py``).

TP (``decoder_tp``) splits one stream's work; DP serves more streams at
once: ``R`` independent engine replicas, each with its own weights and
slot cache on its own device (or its own ``1 x tp`` submesh), behind one
``generate_stream`` with least-busy admission. Replicas share nothing, so
there is no collective. Each stream runs wholly on one replica (a token
stream is stateful); slot batching happens inside the replica. The router
is engine-agnostic: single-stream, speculative, batched and paged engines
alike, quantized or not. A device list may name one device more than
once (every replica then on that card).
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

import torch

from legalrag_tpu_torch.parallel import mesh as mesh_mod
from legalrag_tpu_torch.parallel.decoder_tp import apply_tp_to_engine
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.parallel.decoder_dp")


class DPDecoderRouter:
    """Least-busy router over decode-engine replicas, with the engine
    surface the client uses (``generate_stream``, ``tokenizer``,
    ``close``); any number of threads may stream at once."""

    def __init__(self, engines: Sequence):
        if not engines:
            raise ValueError("DPDecoderRouter needs at least one engine")
        self.engines = list(engines)
        self._active = [0] * len(self.engines)
        self._lock = threading.Lock()
        self.tokenizer = getattr(self.engines[0], "tokenizer", None)

    def _acquire(self) -> int:
        with self._lock:
            i = min(range(len(self.engines)), key=lambda j: self._active[j])
            self._active[i] += 1
            return i

    def _release(self, i: int) -> None:
        with self._lock:
            self._active[i] -= 1

    @property
    def active_per_replica(self) -> List[int]:
        with self._lock:
            return list(self._active)

    def generate_stream(self, prompt_ids: List[int], **kw) -> Iterator[int]:
        """Stream from the least-busy replica (the wrapped engine's
        ``generate_stream`` contract)."""
        i = self._acquire()
        try:
            yield from self.engines[i].generate_stream(prompt_ids, **kw)
        finally:
            self._release(i)

    def close(self) -> None:
        for eng in self.engines:
            close = getattr(eng, "close", None)
            if close is not None:
                close()

    @classmethod
    def from_pretrained(cls, engine_cls, name_or_path: str, replicas: int,
                        tp_shards: int = 0,
                        devices: Optional[Sequence[torch.device]] = None,
                        **kw) -> "DPDecoderRouter":
        """``replicas`` engines of ``engine_cls``, one a device of
        ``devices`` (default: the visible CUDA devices), or with
        ``tp_shards > 1`` one a ``1 x tp`` submesh of consecutive devices
        (DP x TP over ``replicas * tp``). Fewer devices than that raise
        ``ValueError``."""
        tp = max(tp_shards, 1)
        devs = list(devices) if devices is not None \
            else mesh_mod.local_devices()
        need = replicas * tp
        if len(devs) < need:
            raise ValueError(
                f"dp_replicas={replicas} x tp_shards={tp} needs {need} "
                f"devices, have {len(devs)}")
        engines = []
        try:
            for r in range(replicas):
                sub = devs[r * tp:(r + 1) * tp]
                eng = engine_cls.from_pretrained(name_or_path, device=sub[0],
                                                 **kw)
                engines.append(eng)
                if tp > 1:
                    apply_tp_to_engine(eng, mesh_mod.make_mesh(
                        sub, data=1, model=tp))
        except BaseException:
            # a replica that failed to load or split: stop the ones built
            if engines:
                cls(engines).close()
            raise
        log.info("DP decode router: %d replicas x %d-way TP over %s",
                 replicas, tp, [str(d) for d in devs[:need]])
        return cls(engines)
