"""Device surface of the port: field arithmetic, the ed25519 verify kernel
(plain PyTorch version and the CUDA kernel's wrapper), BatchVerifier."""
