"""Training on the card, held against the port's plain twins: B8's
gradient through ``ChunkedMaclaurin`` (the kernel's forward, the twin's
backward) against the twin's own autograd on the card, and a maclaurin
model's loss and gradients at T = 1024, whose forward launches B8 once a
layer and once more where remat reruns the layer, against the same on
the CPU.

Tolerances: B8's output and dq, dk, dv within TWIN_TOL of max|ref| (the
kernel computes its f32 products in 3xTF32; the backward is the twin's on
both sides, fed outputs that differ by that much); the model's gradients
within GRAD_TOL of each leaf's max|grad| (B8's 3xTF32 error carried
through two layers' backward). Marked ``cuda``; each test skips inside
its body where no card is present. On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""

import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.loader import lm_token_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import tuning  # noqa: E402
from repro_torch.kernels.maclaurin_attn import kernel as ma  # noqa: E402
from repro_torch.models import maclaurin_attention as mac  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    OptimizerConfig,
    init_opt_state,
    make_loss_fn,
    make_train_step,
)

pytestmark = pytest.mark.cuda

TWIN_TOL = 1e-4
GRAD_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, tol):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    assert a.shape == b.shape and bool(torch.isfinite(a).all())
    err = float((a - b).abs().max())
    assert err <= tol * max(1e-30, float(b.abs().max())), err


@pytest.mark.parametrize("shape", [(6, 1024, 64, 64), (4, 1024, 128, 128), (3, 1100, 80, 80)])
def test_b8_gradient_against_the_twin(cuda, shape):
    bh, t, d, dv = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k = (0.3 * torch.randn((bh, t, d), generator=g, device=cuda) for _ in range(2))
    v = torch.randn((bh, t, dv), generator=g, device=cuda)
    w = torch.randn((bh, t, dv), generator=g, device=cuda)
    config = tuning.lookup("maclaurin_attn")
    build.reset_counts()
    ours = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = mac.ChunkedMaclaurin.apply(*ours, None, config)
    (out * w).sum().backward()
    assert build.counts()["maclaurin_attention"] == 1
    twin = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = ma.maclaurin_attention_torch(*twin, config=config)
    (ref * w).sum().backward()
    assert build.counts()["maclaurin_attention"] == 1  # the backward launches nothing
    _close(out, ref, TWIN_TOL)
    for a, b in zip(ours, twin):
        _close(a.grad, b.grad, TWIN_TOL)


def test_wrappers_refuse_a_gradient_on_the_card(cuda):
    """B8's and B9's wrappers and ops raise under a gradient on the card,
    before any launch; the chunked route carries one instead."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fa
    from repro_torch.kernels.maclaurin_attn import maclaurin_attention

    q = torch.randn((2, 256, 64), device=cuda, requires_grad=True)
    before = build.counts()
    for fn, args in (
        (ma.maclaurin_attention_cuda, (q, q, q)),
        (fa.flash_attention_cuda, (q, q, q)),
        (maclaurin_attention, (q[None], q[None], q[None])),
        (flash_attention, (q[None], q[None], q[None])),
    ):
        with pytest.raises(RuntimeError, match="the kernel has no backward"):
            fn(*args)
    assert build.counts() == before
    out = mac.maclaurin_attention_chunked(q[None], q[None], q[None])
    assert out.grad_fn is not None
    assert build.counts()["maclaurin_attention"] == before["maclaurin_attention"] + 1


def test_maclaurin_training_gradients_on_the_card(cuda):
    """A reduced model's loss and gradients at T = 1024 on the card against
    the CPU: B8 launched twice a layer (the forward, and remat's rerun of
    it in the backward pass), no kernel on the CPU; then one AdamW step on
    the card, finite."""
    cfg = dataclasses.replace(
        get_config("smollm-135m").reduced(), remat=True, attention_backend="maclaurin"
    )
    cpu = tf.init_params(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    b = lm_token_batches(cfg.vocab_size, 2, 1024, seed=1)(0)
    loss_fn = make_loss_fn(cfg)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params.requires_grad_(True)
        build.reset_counts()
        loss, _ = loss_fn(params, batch)
        loss.backward()
        out[dev] = (loss.detach(), [p.grad for p in params.parameters()])
        out[dev] += (build.counts()["maclaurin_attention"],)
    assert out["cpu"][2] == 0 and out["cuda"][2] == 2 * cfg.n_layers
    _close(out["cuda"][0], out["cpu"][0], 1e-5)
    for a, c in zip(out["cuda"][1], out["cpu"][1]):
        _close(a, c, GRAD_TOL)
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup=0, total_steps=10)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    card, _, m = make_train_step(cfg, ocfg)(card, init_opt_state(ocfg, card, device=cuda), batch, 1)
    assert all(bool(torch.isfinite(p).all()) for p in card.parameters())
    assert bool(torch.isfinite(m["loss"]))
