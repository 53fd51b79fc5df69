"""Stable Diffusion's UNet in the port (``models/sd_unet.py``) against the
plain reference ``tests/plain_sd_unet.py`` on the CPU, at a tiny size: two
levels (the first with transformer blocks), one ResBlock a level, heads of
width 16, a 7 x 24 text context, an 8 x 8 latent and 8 groups. Also B1's
plain path with keys and values of their own length, the ``scaled_linear``
schedule, the text-context conditioning of the sampler plans (graphed DDIM
with guidance, SuperDiff of two prompts) and the published net's names and
shapes on the meta device. There is no JAX counterpart."""

import math

import numpy as np
import pytest
import torch

import plain_sd_unet as plain
from superdiff_torch.diffusion.graphed import GraphedSampler
from superdiff_torch.diffusion.samplers import DDIMPlan, ddim_timesteps
from superdiff_torch.diffusion.schedules import make_schedule
from superdiff_torch.diffusion.superdiff import superdiff_sample
from superdiff_torch.inference import (
    _keeps_f32, apply_sampling_policy, make_eps_fn, make_eps_fn_p)
from superdiff_torch.models.presets import build_model
from superdiff_torch.ops import flash_attention as fa
from superdiff_torch.ops.attention import _math_attention, multihead_attention

torch.set_num_threads(1)

TINY = dict(widths=(32, 64), heads=(2, 4), cross_levels=(True, False),
            layers_per_block=1, context_dim=24, groups=8, norm_eps=1e-5,
            in_channels=4, out_channels=4)
L, R, B = 7, 8, 3


def _tiny_model(dtype=torch.float32):
    c = TINY
    return build_model(
        "sd21base", num_classes=0, compute_dtype=dtype, resolution=R,
        device="cpu", block_out_channels=c["widths"],
        attention_head_dim=c["heads"],
        cross_attention_levels=c["cross_levels"],
        layers_per_block=c["layers_per_block"],
        cross_attention_dim=c["context_dim"], norm_num_groups=c["groups"]
    ).eval()


def _weights(seed=0):
    """Seeded weights with every kernel non-zero: fan-in scaled, biases and
    norm shifts small, norm scales near 1."""
    g = torch.Generator().manual_seed(seed)
    P = {}
    for name, shape in plain.param_shapes(TINY).items():
        w = torch.randn(shape, generator=g)
        if len(shape) > 1:
            w = w * math.prod(shape[1:]) ** -0.5
        elif "norm" in name and name.endswith("weight"):
            w = 1.0 + 0.1 * w
        else:
            w = 0.05 * w
        P[name] = w
    return P


def _inputs(seed=1, batch=B):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, R, R, 4), generator=g)
    t = torch.randint(0, 1000, (batch,), generator=g)
    ctx = torch.randn((batch, L, TINY["context_dim"]), generator=g)
    return x, t, ctx


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def model_and_weights():
    P = _weights()
    model = _tiny_model()
    model.load_state_dict(P, strict=True)
    return model, P


@pytest.mark.parametrize("policy", [False, True])
def test_forward_matches_the_plain_reference(model_and_weights, policy):
    """float32: the same function to float32 round-off (1e-5). The bf16
    sampling policy: convolutions, dense layers and attention in bfloat16
    with the weights it stores rounded, norms' output bfloat16, the time
    embedding and ``conv_out`` float32; against the float32 reference on
    the same rounded weights, each bfloat16 rounding (2^-9 relative) is
    carried through ~25 layers in series, so the output's relative L2
    error stays under 3e-2."""
    model, P = model_and_weights
    x, t, ctx = _inputs()
    ref_P = P
    if policy:
        model = _tiny_model(torch.bfloat16)
        model.load_state_dict(P, strict=True)
        apply_sampling_policy(model)
        ref_P = {k: v if _keeps_f32(k) else v.bfloat16().float()
                 for k, v in P.items()}
    with torch.no_grad(), plain.no_tf32():
        out = model(x, t, ctx)
        ref = plain.forward(ref_P, TINY, x, t, ctx)
    assert out.dtype == torch.float32 and out.shape == x.shape
    if policy:
        assert 0 < _rel(out, ref) < 3e-2
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def _plain_ddim_cfg(P, sched_np, x, ctx, null, steps, scale):
    ts = plain.ddim_grid(1000, steps)
    ab = sched_np
    for i, t in enumerate(ts):
        tt = torch.full((x.shape[0],), int(t))
        e_c = plain.forward(P, TINY, x, tt, ctx)
        e_u = plain.forward(P, TINY, x, tt, null.expand(ctx.shape))
        ab_next = ab[ts[i + 1]] if i + 1 < len(ts) else 1.0
        x = plain.ddim_cfg_step(x, e_c, e_u, scale, float(ab[t]),
                                float(ab_next))
    return x


def test_graphed_ddim_with_context_guidance_matches_the_plain_update(
        model_and_weights):
    """DDIM-4, eta 0, no clipping, guidance 7.5 over a (B, 7, 24) context
    buffer and a null context, run by ``GraphedSampler`` (eagerly on the
    CPU) for two chains through one plan, each chain's contexts copied in
    by ``start``: against the plain update on the float32 reference."""
    model, P = model_and_weights
    sched = make_schedule(1000, "scaled_linear", 0.00085, 0.012,
                          device="cpu")
    ab = np.asarray(sched.alpha_bars, np.float64)
    g = torch.Generator().manual_seed(5)
    null = torch.randn((L, TINY["context_dim"]), generator=g)
    x0, _, ctx0 = _inputs(2)
    plan = DDIMPlan(sched, make_eps_fn(model, "context"), (B, R, R, 4),
                    num_steps=4, eta=0.0, clip_x0=False, y=ctx0,
                    guidance_scale=7.5, null_context=null)
    sampler = GraphedSampler(plan)
    assert sampler.graph is None
    for seed in (2, 3):
        x_init, _, ctx = _inputs(seed)
        with plain.no_tf32():
            got = sampler(x_init=x_init, y=ctx)
            ref = _plain_ddim_cfg(P, ab, x_init, ctx, null, 4, 7.5)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    assert list(ddim_timesteps(1000, 4)) == [750, 500, 250, 0]


@pytest.mark.parametrize("mode", ["or", "and"])
def test_superdiff_of_two_prompts_on_one_unet(model_and_weights, mode):
    """SuperDiff OR and AND of two context-bound eps functions of one
    model (two prompts, one UNet), T = 4: against the plain step."""
    model, P = model_and_weights
    sched = make_schedule(4, "scaled_linear", 0.00085, 0.012, device="cpu")
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randn((L, TINY["context_dim"]), generator=g)
               for _ in range(2)]
    x_init = torch.randn((2, R, R, 4), generator=g)
    noise = [torch.randn((2, R, R, 4), generator=g) for _ in range(4)]
    fns = [make_eps_fn(model, c) for c in prompts]
    with plain.no_tf32():
        x, logq = superdiff_sample(sched, fns, (2, R, R, 4), mode=mode,
                                   x_init=x_init, noise=noise)
        xr = x_init.clone()
        d = xr[0].numel()
        lq = (-0.5 * (xr * xr).flatten(1).sum(1)
              - 0.5 * d * math.log(2 * math.pi))[None].repeat(2, 1)
        betas = np.asarray(sched.betas, np.float64)
        abar = np.asarray(sched.alpha_bars, np.float64)
        for k, t in enumerate(range(3, -1, -1)):
            tt = torch.full((2,), t)
            eps = [plain.forward(P, TINY, xr, tt, c[None].expand(2, -1, -1))
                   for c in prompts]
            xr, lq = plain.superdiff_step(xr, lq, eps, noise[k],
                                          float(betas[t]),
                                          1.0 - float(betas[t]),
                                          float(abar[t]), t, mode)
    torch.testing.assert_close(x, xr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logq, lq, rtol=1e-4, atol=1e-2)


def test_traced_transformer_blocks_hold_their_spans(model_and_weights,
                                                   tmp_path):
    """Inside ``profiling.trace`` each transformer block is one
    ``sd.transformer`` range holding ``sd.attn1``, ``sd.attn2`` and
    ``sd.ff`` in that order; outside it a span is the shared no-op."""
    import json

    from superdiff_torch.utils import profiling

    model, _ = model_and_weights
    x, t, ctx = _inputs()
    with torch.no_grad(), profiling.trace(str(tmp_path)):
        model(x, t, ctx)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    rows = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("name", "").startswith("sd.")),
                  key=lambda e: e["ts"])
    blocks = [e for e in rows if e["name"] == "sd.transformer"]
    assert len(blocks) == 4              # down 1, mid 1, up 2
    for blk in blocks:
        end = blk["ts"] + blk["dur"]
        kids = [e["name"] for e in rows if e is not blk
                and blk["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end]
        assert kids == ["sd.attn1", "sd.attn2", "sd.ff"]
    assert profiling.span("a") is profiling.span("b")


def test_context_mode_of_make_eps_fn_p(model_and_weights):
    model, _ = model_and_weights
    x, t, ctx = _inputs()
    with torch.no_grad():
        per_call = make_eps_fn_p(model, "context")(model, x, t, ctx)
        bound = make_eps_fn_p(model, ctx[0])(model, x, t)
        whole = model(x, t, ctx[:1].expand(B, -1, -1))
    assert torch.equal(bound, whole)
    assert torch.equal(per_call, model(x, t, ctx))
    for bad in (None, 1, torch.zeros(3, dtype=torch.long)):
        with pytest.raises(ValueError, match="context"):
            make_eps_fn_p(model, bad)
    sched = make_schedule(1000, "scaled_linear", 0.00085, 0.012,
                          device="cpu")
    with pytest.raises(ValueError, match="null_context"):
        DDIMPlan(sched, make_eps_fn(model, "context"), (B, R, R, 4),
                 y=ctx, guidance_scale=7.5)


@pytest.mark.parametrize("Bq,Sq,Skv,H,D", [(2, 64, 77, 2, 64),
                                           (1, 100, 13, 3, 32),
                                           (2, 33, 130, 1, 128),
                                           (2, 16, 16, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_plain_path_takes_keys_of_their_own_length(Bq, Sq, Skv, H, D,
                                                      dtype):
    """Skv against Sq, Skv not a multiple of the kernel's key tile (77, 13,
    130): the plain path's output against ``_math_attention`` and its lse
    against the logsumexp of the scores; the dispatch takes it."""
    g = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn((Bq, Sq, H, D), generator=g).to(dtype)
    k, v = (torch.randn((Bq, Skv, H, D), generator=g).to(dtype)
            for _ in range(2))
    out, lse = fa._flash_forward(q, k, v)
    ref = _math_attention(q, k, v)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert out.shape == q.shape and lse.shape == (Bq * H, Sq)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / D ** .5
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1).reshape(
        Bq * H, Sq), rtol=1e-5, atol=1e-5)
    assert torch.equal(multihead_attention(q, k, v), out)
    key = fa._shape_key(q, k)
    assert key == ((Sq, D, str(dtype)[6:]) if Skv == Sq
                   else (Sq, D, str(dtype)[6:], Skv))


def test_b1_shape_rules_with_keys_of_their_own_length():
    q = torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="Skv"):
        fa._flash_forward(q, torch.zeros(2, 5, 2, 32), torch.zeros(2, 6, 2,
                                                                   32))
    with pytest.raises(ValueError):
        fa._flash_forward(q, torch.zeros(1, 5, 2, 32), torch.zeros(1, 5, 2,
                                                                   32))
    kv = torch.zeros(2, 5, 2, 32)
    with pytest.raises(ValueError, match="one"):
        fa._flash_backward(q, kv, kv, q, torch.zeros(4, 8), q)


def test_scaled_linear_table():
    s = make_schedule(1000, "scaled_linear", 0.00085, 0.012, device="cpu")
    want = plain.scaled_linear_alpha_bars(1000, 0.00085, 0.012)
    assert s.alpha_bars.dtype == torch.float32
    np.testing.assert_array_equal(s.alpha_bars.numpy(),
                                  want.astype(np.float32))
    np.testing.assert_allclose(s.betas[[0, -1]].numpy(), [0.00085, 0.012],
                               rtol=1e-6)
    assert not np.allclose(make_schedule(1000, "linear", 0.00085, 0.012,
                                         device="cpu").betas.numpy(),
                           s.betas.numpy())


def test_sd21base_preset_has_diffusers_names_and_published_shapes():
    model = build_model("sd21base", device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = plain.param_shapes(dict(
        widths=(320, 640, 1280, 1280), heads=(5, 10, 20, 20),
        cross_levels=(True, True, True, False), layers_per_block=2,
        context_dim=1024, in_channels=4, out_channels=4))
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 865_910_724
    assert ("down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k"
            ".weight") in got
    assert model.num_classes == 0 and model.context_dim == 1024
