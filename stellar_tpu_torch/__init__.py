"""stellar_tpu_torch — the PyTorch/CUDA port of stellar_tpu, a validator
whose batched ed25519 verify plane and bucket-hash plane run on NVIDIA
Hopper (H100, sm_90a).

The port stands beside the JAX package and imports nothing from it: the
node's host code is copied here, equal to the original in code except for
the seams that tests/test_torch_hostcopy.py names.  Entry points run on the
card (``device="cuda"``, a node's ``SIG_DEVICE``) unless the caller passes
``"cpu"``, which runs each kernel's plain PyTorch version.

The device planes (the port's own):

- ``ops.fe``            GF(2^255-19) arithmetic on (20, N) int32 limbs
- ``ops.ed25519``       point ops, the plain verify kernel, BatchVerifier
- ``ops.ed25519_cuda``  the hand-written Hopper verify kernel's wrapper
- ``ops.sha512``        the device-hash stage (SHA-512(R‖A‖M) mod L), plain
- ``ops.sha512_cuda``   its Hopper kernel's wrapper
- ``ops.sha256``        the bucket-hash SHA-256 stage and packer, plain
- ``ops.sha256_cuda``   its Hopper kernel's wrapper
- ``crypto.sigbackend`` SigBackend / GpuSigBackend / make_backend
- ``crypto.sodium``     libsodium bindings (X25519 in ``crypto.x25519`` and
                        ``os.urandom`` where libsodium does not load)
- ``bucket.hashplane``  the bucket-hash backends and entry points
- ``native``            the C host stage, the node's C engines and the CUDA
                        library builds

The node (copied from the JAX package):

- ``xdr``        wire protocol          - ``crypto``   keys, strkey, hashes
- ``util``       clock, metrics, logs   - ``trace``    span tracer
- ``database``   SQL hot state          - ``ledger``   ledger state machine
- ``tx``         transactions           - ``scp``      consensus protocol
- ``herder``     consensus glue         - ``overlay``  authenticated P2P mesh
- ``bucket``     the bucket list        - ``history``  publish and catchup
- ``invariant``  close-time checks      - ``ingest``   the tx front door
- ``process``    subprocesses           - ``main``     Application, config,
                                          CLI, admin HTTP
- ``simulation`` in-process multi-node simulation and load generation
"""
