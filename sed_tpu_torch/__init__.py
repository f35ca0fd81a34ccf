"""sed_tpu_torch — the PyTorch / CUDA port of ``sed_tpu``.

The JAX package ``sed_tpu`` is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU (or on the CPU through the
plain PyTorch versions of its kernels).  Its layout mirrors ``sed_tpu``:

dsp      log-mel frontend in plain PyTorch (the kernel's plain version)
ops      the hand-written CUDA log-mel kernel's wrapper; wire dequant
models   nn.Module model zoo (CnnSed family: CNN, + BiGRU, + MultiHead)
compat   flax variables / reference .pth -> PyTorch state_dict bridge;
         seeded Transformer weights on the bench checkpoint
serve    wav -> events -> XML serving engine, on-device windowed merging
eval     Evaluator: forward over a split, AP and segment metrics
cli      ``predict``, ``main_strong`` (inference modes) and
         ``optimize_thresholds`` entry points

It imports no JAX.  The numpy-only host modules of ``sed_tpu`` (config,
post-processing, audio I/O, the native event decoder, .npz checkpoints,
the .pth name map, segment metrics) are shared through
``sed_tpu_torch._host`` rather than forked.
"""

__version__ = "0.1.0"
