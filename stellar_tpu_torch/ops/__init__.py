"""Device surface of the port: field arithmetic, the ed25519 verify kernel
(plain PyTorch version and the CUDA kernel's wrapper), BatchVerifier, and
the SHA-512-mod-L and SHA-256 kernels (plain versions and wrappers)."""

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
