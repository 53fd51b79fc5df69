"""The port's sampling service (``superdiff_torch.serve``) and ``cli.serve``
on the CPU, against the JAX service (``superdiff_tpu.serve``).

Parity: the same toy CondUNet weights (seeded numpy values through
``random_params``) in both services, the same seeded request drained with
``step_once``; the port's draws are JAX's key chain for that seed
(``rng, init = split(PRNGKey(seed))``, then ``key, nkey = split(key)`` per
step), injected through ``_launch(..., x_init=, noise=)``. Tolerance: float32
over a few toy-UNet steps, 1e-5 absolute on samples in [-1, 1] (DDIM,
DPM++, CFG: x0 clipped) and up to ~3 (SuperDiff, unclipped); ``logq`` is a
sum of ~1e2 terms of size ~1e2, 1e-5 relative.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu import serve as jserve
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_torch import serve as tserve
from superdiff_torch.compat.flax_params import load_state_dict, random_params
from superdiff_torch.diffusion.schedules import make_schedule
from superdiff_torch.models.unet import CondUNet

torch.set_num_threads(1)

RES, B, T = 16, 4, 10
KW = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
          attn_resolutions=(), num_classes=2,
          time_emb_dim=16, groups=4)
FAST = tserve.SampleSpec(method="ddim", steps=2)
HTTP_TIMEOUT = 60


def _params(seed):
    jm = JaxCondUNet(**KW)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, RES, RES, 1)),
                            jnp.zeros((B,), jnp.int32),
                            jnp.zeros((B,), jnp.int32))
    return {"params": random_params(shapes, seed)}


def _torch_model(params):
    m = CondUNet(resolution=RES, device="cpu", **KW)
    load_state_dict(m, params)
    return m.eval()


@pytest.fixture(scope="module")
def weights():
    return _params(3), _params(4)


def _pair(weights, **kw):
    """A JAX and a port service on the same weights (autostart off)."""
    p1, p2 = weights
    j = jserve.SamplerService(JaxCondUNet(**KW), j_make_schedule(T), p1,
                              resolution=RES, conditional=True,
                              batch_size=B, autostart=False, params2=p2,
                              **kw)
    t = tserve.SamplerService(_torch_model(p1), make_schedule(T, device="cpu"),
                              resolution=RES, conditional=True, batch_size=B,
                              autostart=False, model2=_torch_model(p2), **kw)
    launch = t._launch

    def with_jax_draws(spec, labels, seed):
        """The port's launch with the JAX service's draws for ``seed``."""
        shape = (B, RES, RES, 1)
        rng, init = jax.random.split(jax.random.PRNGKey(seed))
        x_init = torch.from_numpy(np.array(jax.random.normal(init, shape)))
        noise, key = [], rng
        for _ in range(spec.steps):
            key, nkey = jax.random.split(key)
            noise.append(torch.from_numpy(np.array(
                jax.random.normal(nkey, shape))))
        return launch(spec, labels, seed, x_init=x_init, noise=noise)

    t._launch = with_jax_draws
    return j, t


@pytest.fixture(scope="module")
def leading(weights):
    j, t = _pair(weights)
    yield j, t
    j.close()
    t.close()


@pytest.fixture
def port(weights):
    svc = tserve.SamplerService(_torch_model(weights[0]),
                                make_schedule(T, device="cpu"),
                                resolution=RES, conditional=True,
                                batch_size=B, max_wait_ms=5.0,
                                autostart=False)
    yield svc
    svc.close()


def _serve(svc, reqs):
    """Submit ``(num, label, spec, seed)`` requests, drain one batch."""
    handles = [svc.submit(n, label=lab, spec=spec, seed=seed)
               for n, lab, spec, seed in reqs]
    assert svc.step_once() == len(reqs)
    for h in handles:
        assert h.done.is_set() and h.error is None
    return handles


def _close(got, expect, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(got, expect, rtol=rtol, atol=atol)


@pytest.mark.parametrize("spec", [
    dict(method="ddim", steps=3),
    dict(method="dpmpp", steps=4),
], ids=["ddim", "dpmpp"])
def test_seeded_request_matches_jax_service(leading, spec):
    j, t = leading
    spec = tserve.SampleSpec(**spec)
    jspec = jserve.SampleSpec(**spec.__dict__)
    got, = _serve(t, [(3, 1, spec, 11)])
    expect, = _serve(j, [(3, 1, jspec, 11)])
    assert got.result.shape == (3, RES, RES, 1) and got.logq is None
    _close(got.result, expect.result)


def test_trailing_ddim_with_eta_matches_jax_service(weights):
    j, t = _pair(weights, t_spacing="trailing")
    try:
        got, = _serve(t, [(2, 0, tserve.SampleSpec("ddim", 3, 0.5), 5)])
        expect, = _serve(j, [(2, 0, jserve.SampleSpec("ddim", 3, 0.5), 5)])
        _close(got.result, expect.result)
    finally:
        j.close()
        t.close()


def test_coalesced_cfg_batch_with_per_slot_labels_matches_jax(
        leading, monkeypatch):
    """Two unseeded requests (labels 0 and 1) plus a padding slot (the null
    label) in one guided launch; both services draw the batch seed from
    ``os.urandom``, pinned here to one value."""
    j, t = leading
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    spec = dict(method="ddim", steps=2, guidance=3.0)
    got = _serve(t, [(1, 0, tserve.SampleSpec(**spec), None),
                     (2, 1, tserve.SampleSpec(**spec), None)])
    expect = _serve(j, [(1, 0, jserve.SampleSpec(**spec), None),
                        (2, 1, jserve.SampleSpec(**spec), None)])
    for g, e in zip(got, expect):
        _close(g.result, e.result)
    assert not np.allclose(got[0].result[0], got[1].result[0])


def test_superdiff_or_request_and_logq_match_jax_service(leading):
    j, t = leading
    got, = _serve(t, [(2, 1, tserve.SampleSpec("superdiff"), 9)])
    expect, = _serve(j, [(2, 1, jserve.SampleSpec("superdiff"), 9)])
    assert got.logq.shape == (2, 2)
    _close(got.result, expect.result, rtol=1e-5, atol=2e-5)
    _close(got.logq, expect.logq, rtol=1e-5, atol=1e-3)


SPEC_CASES = [
    dict(method="ddim", steps=5),
    dict(method="ddim", steps=5, eta=0.3, guidance=2.0, mode="and"),
    dict(method="ddpm", steps=5),
    dict(method="ddpm", eta=0.5),
    dict(method="dpmpp", steps=7, mode="and"),
    dict(method="dpmpp", eta=0.1),
    dict(method="superdiff", steps=3, mode="and"),
    dict(method="superdiff", mode="xor"),
    dict(method="superdiff", guidance=2.0),
    dict(method="superdiff", eta=0.2),
    dict(method="ddim", steps=0),
    dict(method="ddim", steps=21),
    dict(method="ddim", steps=20),
    dict(method="nope"),
]


@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=[str(i) for i in range(len(SPEC_CASES))])
def test_spec_canonical_matches_jax(case):
    def canon(mod):
        try:
            return mod.SampleSpec(**case).canonical(20).__dict__
        except ValueError as e:
            return f"ValueError: {e}"

    assert canon(tserve) == canon(jserve)


def test_validation(port):
    for bad in (dict(num=B + 1), dict(num=0), dict(num=1, label=2),
                dict(num=1, label=-1),
                dict(num=1, spec=tserve.SampleSpec("superdiff")),
                dict(num=1, spec=tserve.SampleSpec(steps=T + 1))):
        kw = {"spec": FAST, **bad}
        with pytest.raises(ValueError):
            port.submit(**kw)
    assert port.stats["requests"] == 0


def test_coalescing_specs_that_do_not_mix_and_no_starvation(port):
    slow = tserve.SampleSpec(method="ddim", steps=3)
    r1 = port.submit(2, label=0, spec=FAST)
    r2 = port.submit(1, label=1, spec=FAST)
    rb = port.submit(1, spec=slow)
    r3 = port.submit(1, spec=FAST)
    assert port.step_once() == 3            # r1, r2, r3 in one launch
    assert port.stats["coalesced"] == 2 and port.stats["batches"] == 1
    assert not rb.done.is_set()
    assert [r.result.shape[0] for r in (r1, r2, r3)] == [2, 1, 1]
    assert not np.allclose(r1.result[0], r2.result[0])   # per-slot labels
    rc = port.submit(1, spec=FAST)          # the deferred spec goes first
    assert port.step_once() == 1 and rb.done.is_set() and not rc.done.is_set()
    assert port.step_once() == 1 and rc.done.is_set()
    assert port.stats["compiles"] == 2 and port.stats["samples"] == 6


def test_seeded_requests_ride_alone_and_reproduce(port):
    ra = port.submit(2, label=0, spec=FAST, seed=7)
    rb = port.submit(1, label=1, spec=FAST)
    assert port.step_once() == 1 and not rb.done.is_set()
    assert port.step_once() == 1 and rb.done.is_set()
    rc, = _serve(port, [(2, 0, FAST, 7)])
    np.testing.assert_array_equal(ra.result, rc.result)
    rd, = _serve(port, [(2, 0, FAST, 8)])
    assert not np.allclose(ra.result, rd.result)


def test_unconditional_service_rejects_label_and_serves(weights):
    svc = tserve.SamplerService(
        CondUNet(resolution=RES, device="cpu",
                 **{**KW, "num_classes": 0}).init_parameters(0),
        make_schedule(T, device="cpu"), resolution=RES, conditional=False,
        batch_size=B, autostart=False, t_spacing="trailing")
    try:
        with pytest.raises(ValueError, match="unconditional"):
            svc.submit(1, label=1, spec=FAST)
        # guidance folds to 1.0: one graph for both requests
        a = svc.submit(1, spec=tserve.SampleSpec("ddim", 1, guidance=3.0))
        b = svc.submit(1, spec=tserve.SampleSpec("ddim", 1))
        assert svc.step_once() == 2 and svc.stats["compiles"] == 1
        assert np.isfinite(a.result).all() and b.result.shape[0] == 1
    finally:
        svc.close()
    with pytest.raises(ValueError, match="t_spacing"):
        tserve.SamplerService(svc._model, svc._schedule, resolution=RES,
                              conditional=False, autostart=False,
                              t_spacing="sideways")


def test_encode_images_matches_jax():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1.2, 1.2, (3, RES, RES + 2, 1)).astype(np.float32)
    for fmt in ("npy", "png"):
        got, ctype = tserve.encode_images(imgs, fmt)
        expect, jtype = jserve.encode_images(imgs, fmt)
        assert ctype == jtype
        if fmt == "npy":
            assert got == expect          # the same np.save bytes
            continue
        from PIL import Image
        pix = [np.array(Image.open(io.BytesIO(base64.b64decode(d))))
               for d in (got, expect)]
        assert pix[0].shape == (RES, 3 * (RES + 2)) and pix[0].dtype == np.uint8
        np.testing.assert_array_equal(pix[0], pix[1])
    with pytest.raises(ValueError):
        tserve.encode_images(imgs, "jpeg")


def _get(url):
    return json.load(urllib.request.urlopen(url, timeout=HTTP_TIMEOUT))


def _post(url, body):
    return json.load(urllib.request.urlopen(urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST"),
        timeout=HTTP_TIMEOUT))


def test_http_end_to_end(weights):
    p1, p2 = weights
    svc = tserve.SamplerService(_torch_model(p1),
                                make_schedule(T, device="cpu"),
                                resolution=RES, conditional=True,
                                batch_size=B, max_wait_ms=5.0,
                                model2=_torch_model(p2))
    httpd = tserve.make_http_server(svc, "127.0.0.1", 0,
                                    info={"preset": "tiny"})
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        h = _get(f"{base}/healthz")
        assert h == {"status": "ok", "backend": "cpu", "devices": 1}
        inf = _get(f"{base}/info")
        assert inf["resolution"] == RES and inf["batch_size"] == B
        assert inf["preset"] == "tiny" and inf["methods"][-1] == "superdiff"
        body = {"num": 2, "label": 1, "method": "ddim", "steps": 2,
                "format": "npy", "seed": 3}
        a, b = _post(f"{base}/sample", body), _post(f"{base}/sample", body)
        assert a["shape"] == [2, RES, RES, 1] and a["data"] == b["data"]
        arr = np.load(io.BytesIO(base64.b64decode(a["data"])))
        assert np.isfinite(arr).all()
        sd = _post(f"{base}/sample", {"num": 1, "method": "superdiff",
                                      "seed": 1})
        assert sd["content_type"] == "image/png" and len(sd["logq"]) == 2
        for bad, code in (({"num": 99, "steps": 2}, 400),
                          ({"num": 1, "method": "ddim", "eta": "x"}, 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{base}/sample", bad)
            assert ei.value.code == code and "error" in json.load(ei.value)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/nowhere")
        assert ei.value.code == 404
        m = _get(f"{base}/metrics")
        assert m["samples"] == 5 and m["batches"] == 3 and m["compiles"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    th.join(timeout=HTTP_TIMEOUT)
    assert not th.is_alive()


def test_failed_launch_is_a_500_and_the_worker_survives(weights, monkeypatch):
    svc = tserve.SamplerService(_torch_model(weights[0]),
                                make_schedule(T, device="cpu"),
                                resolution=RES, conditional=True,
                                batch_size=B, max_wait_ms=5.0)
    httpd = tserve.make_http_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def broken(spec):
        raise RuntimeError("capture failed")

    try:
        with monkeypatch.context() as mp:
            mp.setattr(svc, "_get_jit", broken)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{base}/sample", {"num": 1, "steps": 2})
            assert ei.value.code == 500
            assert "capture failed" in json.load(ei.value)["error"]
        ok = _post(f"{base}/sample", {"num": 1, "steps": 2, "format": "npy"})
        assert ok["shape"] == [1, RES, RES, 1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    th.join(timeout=HTTP_TIMEOUT)
