"""multiverse_torch — the PyTorch / CUDA port of multiverse_tpu.

The K-beam multi-future inference path, held against the JAX package
``multiverse_tpu`` on the same weights and inputs. Plain tensor code is
PyTorch; the fused beam decode step is a hand-written CUDA kernel for
Hopper (``csrc/fused_decode.cu``), built with nvcc at first use. This
package never imports jax: of the JAX package it uses only the jax-free
``multiverse_tpu.config`` and ``multiverse_tpu.native``.

Layout (module names follow ``multiverse_tpu``):
    geometry.py    grid geometry, rasterisation, one-hot cell maps
    ops/           conv2d, ConvLSTM, GNN, the fused decode step and its
                   nvcc/ctypes build step
    models/        Multiverse parameters, scene CNN, greedy decode,
                   diverse beam search
    data/          scene segmentation helpers (numpy)
    inference.py   beam_forward, the offline run, pickle outputs
    bridge.py      weights from the JAX parameter tree and npz files
    cli/           mvt-torch-multifuture-inference
"""

__version__ = "0.1.0"
