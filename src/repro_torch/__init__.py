"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

It mirrors ``repro``'s layout module for module, so the counterpart of
``repro/core/maclaurin.py`` is ``repro_torch/core/maclaurin.py``. The
serving path (exact ``SVMModel`` -> ``approximate`` -> maclaurin
``compile`` -> ``SVMEngine``) runs on a CUDA card through two kernels
written by hand for Hopper (``csrc/*.cu``); on CPU tensors every kernel
wrapper computes with its plain PyTorch twin instead.

Entry points (``SVMEngine``, ``CompiledArtifact.load``, ``convert.*``)
default to ``torch.device("cuda")`` and raise when no card is present,
unless the caller passes ``device="cpu"``.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""
