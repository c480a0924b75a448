"""multiverse_torch — the PyTorch / CUDA port of multiverse_tpu.

The K-beam and greedy multi-future inference paths, serving, training
and SimAug training, held against the JAX package ``multiverse_tpu`` on
the same weights and inputs. Plain tensor code is PyTorch; every TPU kernel on
those paths is a hand-written CUDA kernel for Hopper (``csrc/``), built
with nvcc at first use. This package imports nothing of jax or of the
JAX package: it keeps its own copies of the host-only modules it needs.

Layout (module names follow ``multiverse_tpu``):
    config.py      the configuration dataclass
    geometry.py    grid geometry, rasterisation, one-hot cell maps
    ops/           conv2d, ConvLSTM, GNN, the fused decode steps, the
                   training attention kernels, their nvcc/ctypes build
    models/        Multiverse parameters, scene CNN, greedy decode,
                   model_forward and the losses, diverse beam search,
                   SimAug (attack, multiview augmentation, loss)
    data/          the training dataset, SimAug's multi-view grouping,
                   batch prefetch, scene helpers
    train/         optimizers and train steps, evaluation, checkpoints
    eval/          scoring of output pickles (numpy)
    inference.py   beam_forward, greedy_forward, the offline run
    decode_graphs.py  the offline run's CUDA graphs of the encoders and
                   the regression head
    serving/       the serving engine and its HTTP front ends
    bridge.py      weights to and from the JAX parameter tree and npz
    tools/         the TF1 tensor-bundle reader and checkpoint converter
    cli/           mvt-torch-train, mvt-torch-train-simaug,
                   mvt-torch-test, mvt-torch-multifuture-inference,
                   mvt-torch-serve, mvt-torch-eval-trajs,
                   mvt-torch-eval-prob, mvt-torch-evaluate-sdd,
                   mvt-torch-convert-tf
"""

__version__ = "0.1.0"
