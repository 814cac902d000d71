"""PyTorch and CUDA port of speech2affective_gestures_tpu for NVIDIA Hopper.

The JAX package beside this one stays the reference; this package imports
nothing from it. Entry points run on `cuda` unless the caller passes
`device="cpu"`, in which case every kernel wrapper takes its plain PyTorch
version (see `device.resolve_device`).
"""
