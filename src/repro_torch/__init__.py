"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

It mirrors ``repro``'s layout module for module, so the counterpart of
``repro/core/maclaurin.py`` is ``repro_torch/core/maclaurin.py``. Five
paths run on a CUDA card through nine kernels written by hand for Hopper
(``csrc/*.cu``, B1-B9):

1. serving an exact ``SVMModel`` collapsed to the maclaurin artifact
   through ``SVMEngine`` (B1 ``quadform_heads``, with the exact fallback
   B2 ``rbf_scores``);
2. ``compile_model`` over the maclaurin, poly2 and dense fourier families
   at f32 and int8, and serving the result (B1, B3 ``quadform_heads_q8``,
   B4 ``rff_score``, B5 ``rff_score_q8``);
3. training (``svm``: LS-SVM, dual C-SVC, one-vs-rest) and the Fastfood
   fourier artifacts at f32 and int8 (B6 ``fastfood_score``, B7
   ``fastfood_score_q8``);
4. the LM side (``configs``, ``models``, ``serve.decode_step``): prefill
   and decode of the dense decoder family, with flash attention (B9
   ``flash_attention``) and the paper's collapse applied to attention
   (B8 ``maclaurin_attention``; decode from the O(d^2) ``MacState``);
5. the multi-tenant serving runtime (``serve.runtime``: registry,
   coalescing, admission control, the circuit breaker degrading to B2,
   the drift guard recompiling through ``compile_model``) in front of
   ``SVMEngine``.

On CPU tensors every kernel wrapper computes with its plain PyTorch twin
instead. Entry points (``SVMEngine``, ``Runtime``, ``CompiledArtifact.load``,
``convert.*``, ``models.transformer.init_params`` and ``init_cache``)
default to ``torch.device("cuda")`` and raise when no card is present,
unless the caller passes ``device="cpu"``.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""
