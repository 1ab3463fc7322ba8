"""stellar_tpu_torch — the PyTorch/CUDA port of stellar_tpu's batched
ed25519 verify plane and bucket-hash plane, for NVIDIA Hopper (H100,
sm_90a).

The port stands beside the JAX package and imports nothing from it: what
it needs of the host code (the ref25519 oracle, libsodium bindings, the
verify cache, the C host stage) is copied here.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, which
runs each kernel's plain PyTorch version.

- ``ops.fe``            GF(2^255-19) arithmetic on (20, N) int32 limbs
- ``ops.ed25519``       point ops, the plain verify kernel, BatchVerifier
- ``ops.ed25519_cuda``  the hand-written Hopper verify kernel's wrapper
- ``ops.sha512``        the device-hash stage (SHA-512(R‖A‖M) mod L), plain
- ``ops.sha512_cuda``   its Hopper kernel's wrapper
- ``ops.sha256``        the bucket-hash SHA-256 stage and packer, plain
- ``ops.sha256_cuda``   its Hopper kernel's wrapper
- ``crypto.sigbackend`` SigBackend / GpuSigBackend / make_backend
- ``bucket.hashplane``  the bucket-hash backends and entry points
- ``native``            the C host stage (gate + SHA-512 mod L + staging,
                        batched SHA-256) and the CUDA library builds
"""
