"""The example scripts (port of the repository's `examples/`), each runnable
as `python -m orb_slam2_tpu_torch.examples.<name> ...` with the JAX
script's command line, and each exposing `main(argv=None, device="cuda")`.
"""
