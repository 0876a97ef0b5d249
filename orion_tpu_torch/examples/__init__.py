"""Encrypted inference end to end, one script per model: the
counterparts of orion_tpu's `examples/run_*.py`.

    python -m orion_tpu_torch.examples.run_mlp [--config configs/mlp.yml]
    python -m orion_tpu_torch.examples.run_resnet --fhe

Each runs on the GPU; `--cpu` runs the plain PyTorch path on the host
(`device="cpu"`).  orion_tpu's `--aot` and `--whole-jit` choose how XLA
compiles the forward and have no counterpart: the port runs eagerly.
"""
