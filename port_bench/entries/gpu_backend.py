"""The system under test of the verify-backend cells: the port's
``GpuSigBackend`` built from a configuration's ``Config`` knobs as the node
builds it (``main/application.py``), without the verify cache in front.

``build(knobs, caller, device, tracer)`` returns the object the window
drives: ``call(items)`` is ``verify_batch(items, caller=caller)``;
``stats()`` the backend's counters; ``close()`` drops the backend.
"""

from __future__ import annotations


class Entry:
    def __init__(self, knobs: dict, caller: str, device: str, tracer=None):
        from stellar_tpu_torch.crypto.sigbackend import GpuSigBackend
        from stellar_tpu_torch.main.config import Config

        cfg = Config.from_dict({**knobs, "SIG_DEVICE": device})
        if cfg.SIGNATURE_BACKEND != "gpu":
            raise ValueError("this entry drives the gpu backend: SIGNATURE_BACKEND must be \"gpu\"")
        self.caller = caller
        self.backend = GpuSigBackend(
            max_batch=cfg.SIG_BATCH_MAX,
            sig_mesh=cfg.SIG_MESH,
            device=cfg.SIG_DEVICE,
            device_hash=bool(cfg.DEVICE_HASH),
            cpu_cutover=cfg.GPU_CPU_CUTOVER,
            streams=cfg.SIG_VERIFY_STREAMS,
            tracer=tracer,
        )

    def call(self, items):
        return self.backend.verify_batch(items, caller=self.caller)

    def stats(self) -> dict:
        return self.backend.stats()

    def close(self) -> None:
        self.backend = None


def build(knobs: dict, caller: str, device: str, tracer=None) -> Entry:
    return Entry(knobs, caller, device, tracer)
