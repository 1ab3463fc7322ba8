"""Device surface of the port: field arithmetic, the ed25519 verify kernel
(plain PyTorch version and the CUDA kernel's wrapper), BatchVerifier, and
the SHA-512-mod-L and SHA-256 kernels (plain versions and wrappers)."""

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """An entry point's device: the card unless the caller asks for the CPU.
    A CUDA device on a host without CUDA raises — never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "stellar_tpu_torch: CUDA is not available; pass device='cpu' "
                "to run the plain PyTorch version"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def launch_device(device: torch.device):
    """The context of a kernel launch on the CUDA ``device``: the runtime
    launches on its current device, so a launch on another card's stream
    makes that card current around it.  When the card already is current
    (one card, or inside a stream context of that card) nothing is switched:
    the switch and its restore add ~10 µs to a small kernel's call
    (``path_ab.py`` on an H100 host)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
