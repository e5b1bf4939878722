"""The benchmark's plain float32 reference: plain PyTorch operations only,
nothing of the program under test, of JAX or of the JAX package."""
