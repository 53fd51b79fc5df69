"""Inference serving: micro-batched sampling service + stdlib HTTP app.

Port of ``superdiff_tpu/serve.py``, with the same names and behaviour:
``SampleSpec``, ``SamplerService`` (``submit`` / ``sample_request`` /
``sample`` / ``warmup`` / ``step_once`` / ``close``), ``encode_images`` and
``make_http_server`` (``/healthz /info /metrics /sample``).

Design on the card:

- **One CUDA graph per spec.** The JAX service compiles one fixed-shape
  executable per ``(method, steps, eta, guidance, mode)`` spec at its fixed
  batch size. Here each spec gets a
  :class:`~superdiff_torch.diffusion.graphed.GraphedSampler`: the sampler's
  one step captured as a CUDA graph at the service's batch size (CFG's 2B
  stacked inside) and replayed once per step, so a request pays no Python
  dispatch per denoiser call. ``stats["compiles"]`` counts captures. The
  graphs share one memory pool. A capture that fails raises, and the
  request gets a 500; there is no eager fallback on the card. On the CPU
  the same objects run their step eagerly.
- **Micro-batching across requests.** One worker thread owns the device:
  it alone touches CUDA (captures, draws, replays); HTTP threads only
  encode numpy. It coalesces queued unseeded requests with the same spec
  into one batch; per-slot class labels ride a ``y`` buffer, so requests
  for different classes share a graph and a launch.
- **Seeds.** A batch draws from ``torch.Generator(device).manual_seed(seed)``
  (the initial sample, then one draw per step). A seeded request rides
  alone, so its result depends only on (spec, num, label, seed, batch
  size); an unseeded batch draws a fresh seed.

With a second model (``model2=``) the service also serves
``method="superdiff"`` and returns the per-sample Itô log-densities in the
response's ``logq`` field.

Data parallelism (``mesh=``, a mesh of more than one process): rank 0 runs
the HTTP app and the coalescing; it broadcasts each coalesced batch's spec,
labels and seed to the other ranks, which sit in :meth:`follow` and serve
their rows of it from their own CUDA graphs; every rank draws the whole
batch's noise and keeps its rows, and rank 0 gathers the rows, so a seeded
request gives the single-process bits.

Usage (see ``cli/serve.py`` for flags)::

    python -m superdiff_torch.cli.serve --run-dir RUN --port 8000
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/sample \\
        -d '{"num": 4, "label": 1, "method": "dpmpp", "steps": 10}'
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from superdiff_torch.diffusion.graphed import GraphedSampler, pool_bytes
from superdiff_torch.diffusion.samplers import DDIMPlan, DDPMPlan, DPMppPlan
from superdiff_torch.diffusion.superdiff import SuperDiffPlan
from superdiff_torch.inference import make_eps_fn_p
from superdiff_torch.utils.visualization import png_bytes

_METHODS = ("ddpm", "ddim", "dpmpp", "superdiff")
_SD_MODES = ("or", "and")

_log = logging.getLogger("superdiff_torch.serve")


@dataclass(frozen=True)
class SampleSpec:
    """Everything that selects a captured graph (batch-shape static)."""
    method: str = "ddim"
    steps: int = 50
    eta: float = 0.0
    guidance: float = 1.0
    mode: str = "or"              # superdiff mixing mode (ignored otherwise)

    def canonical(self, T: int) -> "SampleSpec":
        """Validate and normalize to the graph-cache key. Fields a method
        ignores are folded to one canonical value so equivalent requests
        never capture twice: ``ddpm`` always runs the full schedule (steps
        -> T) and is ancestral (eta rejected, like dpmpp); only ddim
        consumes eta; only superdiff consumes mode."""
        if self.method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}")
        if self.method != "ddim" and self.eta:
            raise ValueError("eta only applies to ddim (ddpm is ancestral "
                             "at full T; dpmpp is an ODE)")
        if self.method == "superdiff":
            if self.mode not in _SD_MODES:
                raise ValueError(f"mode must be one of {_SD_MODES}")
            if self.guidance != 1.0:
                raise ValueError("guidance does not apply to superdiff "
                                 "(the mixture IS the conditioning)")
        steps = (int(T) if self.method in ("ddpm", "superdiff")
                 else int(self.steps))
        if not 1 <= steps <= T:
            raise ValueError(f"steps must be in [1, {T}]")
        mode = self.mode if self.method == "superdiff" else "or"
        return SampleSpec(self.method, steps, float(self.eta),
                          float(self.guidance), mode)

    def validate(self, T: int) -> None:
        self.canonical(T)


@dataclass
class _Request:
    num: int
    labels: np.ndarray            # (num,) int32 (null label when uncond)
    spec: SampleSpec
    seed: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    logq: Optional[np.ndarray] = None   # (2, num) Itô log-densities (superdiff)
    error: Optional[Exception] = None


class SamplerService:
    """Micro-batching sampler around one loaded model (and optionally a
    second, for SuperDiff), on the schedule's device.

    ``submit`` is non-blocking (returns a ``_Request`` handle), ``sample``
    blocks. The worker thread drains the queue; ``autostart=False`` plus
    ``step_once()`` gives tests a deterministic single-threaded drain.
    """

    def __init__(self, model, schedule, resolution: int, conditional: bool,
                 batch_size: int = 16, max_wait_ms: float = 20.0,
                 autostart: bool = True, model2=None,
                 t_spacing: str = "leading", clip_x0: bool = True,
                 mesh=None):
        if t_spacing not in ("leading", "trailing"):
            raise ValueError(f"t_spacing must be leading/trailing, got "
                             f"{t_spacing!r}")
        # run-level grid policy, not a request knob: a distilled student is
        # only trained at its stamped grid nodes and on the unclipped
        # transition, so serving it otherwise samples off-manifold
        self._t_spacing = t_spacing
        self._clip_x0 = bool(clip_x0)
        self._model = model
        self._model2 = model2
        self._schedule = schedule
        self._device = schedule.device
        self._resolution = int(resolution)
        self._conditional = bool(conditional)
        self._B = int(batch_size)
        self._max_wait = max_wait_ms / 1e3
        self._mesh = mesh
        self._closed = False
        self._rows = None
        if mesh is not None:
            from superdiff_torch.parallel.mesh import local_rows
            self._rows = local_rows(self._B, mesh)
        self._null = int(getattr(model, "null_label", 0))
        self._num_classes = int(getattr(model, "num_classes", 0) or 0)
        self._pool = (torch.cuda.graph_pool_handle()
                      if self._device.type == "cuda" else None)

        self._jits: Dict[SampleSpec, GraphedSampler] = {}
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # Requests pulled off the queue but not servable in the current
        # batch (different spec, or seeded). Worker-thread-only state,
        # FIFO by arrival: the oldest deferred request leads the next
        # cycle, so a minority spec is never starved.
        self._pending: List[_Request] = []
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "samples": 0, "batches": 0,
                      "coalesced": 0, "compiles": 0, "device_ms_total": 0.0,
                      "graph_pool_gb": 0.0}
        self._stop = threading.Event()
        self._thread = None
        if autostart:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- public
    @property
    def batch_size(self) -> int:
        return self._B

    @property
    def resolution(self) -> int:
        return self._resolution

    @property
    def device(self) -> torch.device:
        return self._device

    def submit(self, num: int, label: Optional[int] = None,
               spec: Optional[SampleSpec] = None,
               seed: Optional[int] = None) -> _Request:
        spec = (spec or SampleSpec()).canonical(
            self._schedule.num_timesteps)
        if spec.method == "superdiff" and self._model2 is None:
            raise ValueError("service holds one model; superdiff needs a "
                             "second (--run-dir2)")
        if not self._conditional and spec.guidance != 1.0:
            # guidance never reaches the unconditional sampler; fold it so
            # clients varying it don't each capture an identical graph
            spec = SampleSpec(spec.method, spec.steps, spec.eta, 1.0,
                              spec.mode)
        if not 1 <= num <= self._B:
            raise ValueError(f"num must be in [1, {self._B}] "
                             "(the service's fixed batch size)")
        if label is not None and not self._conditional:
            raise ValueError("model is unconditional; omit label")
        if label is not None and self._num_classes \
                and not 0 <= int(label) < self._num_classes:
            # an embedding gather would condition on the wrong row (or
            # fault on the card); reject at the boundary instead
            raise ValueError(f"label must be in [0, {self._num_classes})")
        lab = self._null if label is None else int(label)
        req = _Request(num=num,
                       labels=np.full((num,), lab, dtype=np.int32),
                       spec=spec, seed=seed)
        with self._lock:
            self.stats["requests"] += 1
        self._q.put(req)
        return req

    def sample_request(self, num: int, label: Optional[int] = None,
                       spec: Optional[SampleSpec] = None,
                       seed: Optional[int] = None,
                       timeout: float = 600.0) -> _Request:
        """Blocking submit: returns the completed request (``result`` +
        ``logq`` for superdiff specs), raising its error/timeout."""
        req = self.submit(num, label=label, spec=spec, seed=seed)
        if not req.done.wait(timeout):
            raise TimeoutError("sampling request timed out")
        if req.error is not None:
            raise req.error
        return req

    def sample(self, num: int, label: Optional[int] = None,
               spec: Optional[SampleSpec] = None,
               seed: Optional[int] = None,
               timeout: float = 600.0) -> np.ndarray:
        return self.sample_request(num, label=label, spec=spec, seed=seed,
                                   timeout=timeout).result

    def warmup(self, spec: Optional[SampleSpec] = None) -> float:
        """Capture + run one batch of ``spec`` so the first real request
        pays steady-state latency. Returns seconds spent."""
        tic = time.time()
        self.sample(1, spec=spec, seed=0)
        return time.time() - tic

    def step_once(self, block: bool = True) -> int:
        """Drain one coalesced batch (test/diagnostic path). Returns the
        number of requests served."""
        first = self._next_request(block)
        if first is None:
            return 0
        return self._serve_batch(first)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._group() is not None and not self._closed:
            self._broadcast(None)           # releases the followers
        self._closed = True

    def follow(self) -> int:
        """The loop of a rank other than 0 under a mesh: serve its rows of
        each batch rank 0 broadcasts, until rank 0 closes. Returns the
        number of batches served."""
        n = 0
        while True:
            msg = self._broadcast(None)
            if msg is None:
                return n
            spec, labels, seed = msg
            self._launch(spec, labels, seed)
            n += 1

    def _group(self):
        return None if self._mesh is None else self._mesh.group("data")

    def _broadcast(self, msg):
        """``msg`` from rank 0 of the data group to every rank of it."""
        import torch.distributed as dist

        group = self._group()
        box = [msg]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
        return box[0]

    # ------------------------------------------------------------ worker
    def _run(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while not self._stop.is_set():
            first = self._next_request(block=True, timeout=0.1)
            if first is None:
                continue
            try:
                self._serve_batch(first)
            except Exception:       # worker must survive bad launches;
                # the requests already carry the error (``_serve_batch``
                # sets it before re-raising) — record it server-side too
                _log.exception("sampling batch failed")

    def _next_request(self, block: bool = True,
                      timeout: Optional[float] = None) -> Optional[_Request]:
        """Oldest deferred request first, then the queue (worker thread /
        ``step_once`` only)."""
        if self._pending:
            return self._pending.pop(0)
        try:
            return self._q.get(block=block, timeout=timeout
                               if timeout is not None
                               else (self._max_wait if block else None))
        except queue.Empty:
            return None

    def _serve_batch(self, first: _Request) -> int:
        """Coalesce waiting unseeded requests sharing ``first.spec`` into
        one launch. Seeded requests always ride alone. Non-matching
        requests are deferred to ``_pending`` in arrival order and lead the
        next cycle."""
        batch: List[_Request] = [first]
        slots = first.num
        if first.seed is None:
            kept: List[_Request] = []
            for r in self._pending:       # older deferred matches first
                if (r.seed is None and r.spec == first.spec
                        and slots + r.num <= self._B):
                    batch.append(r)
                    slots += r.num
                else:
                    kept.append(r)
            self._pending = kept
            deadline = time.time() + self._max_wait
            while slots < self._B and time.time() < deadline:
                try:
                    nxt = self._q.get(
                        timeout=max(0.0, deadline - time.time()))
                except queue.Empty:
                    break
                if (nxt.seed is None and nxt.spec == first.spec
                        and slots + nxt.num <= self._B):
                    batch.append(nxt)
                    slots += nxt.num
                else:
                    self._pending.append(nxt)

        labels = np.full((self._B,), self._null, dtype=np.int32)
        off = 0
        for r in batch:
            labels[off:off + r.num] = r.labels
            off += r.num
        seed = (first.seed if first.seed is not None
                else int.from_bytes(os.urandom(4), "little"))

        try:
            if self._group() is not None:
                self._broadcast((first.spec, labels, int(seed)))
            imgs, logq = self._launch(first.spec, labels, int(seed))
        except Exception as e:
            for r in batch:
                r.error = e
                r.done.set()
            raise
        off = 0
        for r in batch:
            r.result = imgs[off:off + r.num]
            if logq is not None:
                r.logq = logq[:, off:off + r.num]
            off += r.num
            r.done.set()
        with self._lock:
            self.stats["batches"] += 1
            self.stats["samples"] += slots
            self.stats["coalesced"] += len(batch) - 1
        return len(batch)

    # ------------------------------------------------------------ device
    def _eps_fn(self, model):
        """``(x, t[, y]) -> eps`` of one model: per-slot labels ``y`` for a
        conditional service."""
        applyp = make_eps_fn_p(model, "per_sample" if self._conditional
                               else None, schedule=self._schedule)
        return lambda *a: applyp(model, *a)

    def _get_jit(self, spec: SampleSpec) -> GraphedSampler:
        """The spec's graphed sampler, captured at first use."""
        fn = self._jits.get(spec)
        if fn is not None:
            return fn
        shape = (self._B, self._resolution, self._resolution, 1)
        schedule = self._schedule
        y = (torch.full((self._B,), self._null, dtype=torch.long,
                        device=self._device) if self._conditional else None)
        if spec.method == "superdiff":
            plan = SuperDiffPlan(schedule, [self._eps_fn(self._model),
                                            self._eps_fn(self._model2)],
                                 shape, mode=spec.mode, y=y, rows=self._rows)
        else:
            kw = dict(y=y, guidance_scale=spec.guidance,
                      null_label=self._null, rows=self._rows)
            eps = self._eps_fn(self._model)
            if spec.method == "ddim":
                plan = DDIMPlan(schedule, eps, shape, num_steps=spec.steps,
                                eta=spec.eta, t_spacing=self._t_spacing,
                                clip_x0=self._clip_x0, **kw)
            elif spec.method == "dpmpp":
                plan = DPMppPlan(schedule, eps, shape, num_steps=spec.steps,
                                 clip_x0=self._clip_x0, **kw)
            else:
                plan = DDPMPlan(schedule, eps, shape, **kw)
        fn = GraphedSampler(plan, pool=self._pool)
        self._jits[spec] = fn
        with self._lock:
            self.stats["compiles"] += 1
            if self._pool is not None:
                self.stats["graph_pool_gb"] = pool_bytes(self._pool) / 1e9
        return fn

    def _launch(self, spec: SampleSpec, labels: np.ndarray, seed: int,
                x_init: Optional[torch.Tensor] = None,
                noise=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns ``(images, logq)`` — ``logq`` is the (2, B) Itô
        log-density matrix for superdiff specs, None otherwise.
        ``x_init`` / ``noise`` replace the generator's draws (the JAX-parity
        tests inject JAX's)."""
        fn = self._get_jit(spec)
        tic = time.time()
        g = torch.Generator(device=self._device).manual_seed(seed)
        y = (torch.from_numpy(labels).to(self._device, torch.long)
             if self._conditional else None)
        out = fn(g, y=y, x_init=x_init, noise=noise)
        x, logq = out if spec.method == "superdiff" else (out, None)
        if self._mesh is not None:
            from superdiff_torch.parallel.mesh import gather_rows
            x = gather_rows(x, self._mesh)
            logq = None if logq is None else gather_rows(logq, self._mesh,
                                                         dim=1)
        imgs = x.float().cpu().numpy()
        logq = None if logq is None else logq.float().cpu().numpy()
        with self._lock:
            self.stats["device_ms_total"] += (time.time() - tic) * 1e3
        return imgs, logq


# ------------------------------------------------------------------ HTTP
def encode_images(imgs: np.ndarray, fmt: str = "png") -> Tuple[str, str]:
    """Encode a (N, H, W, 1) float batch. Returns (base64, content_type).

    ``png``: one horizontal grid, [-1, 1] -> uint8 (8-bit grayscale, the
    port's own writer, ``utils/visualization.png_bytes``). ``npy``: the raw
    float32 array serialized with ``np.save`` (lossless,
    machine-consumable)."""
    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, imgs)
        return (base64.b64encode(buf.getvalue()).decode("ascii"),
                "application/x-npy")
    if fmt != "png":
        raise ValueError("format must be 'png' or 'npy'")
    u8 = (np.clip((imgs[..., 0] + 1.0) / 2.0, 0.0, 1.0) * 255
          ).astype(np.uint8)                       # (N, H, W)
    grid = np.concatenate(list(u8), axis=1)        # (H, N*W)
    return base64.b64encode(png_bytes(grid)).decode("ascii"), "image/png"


def make_http_server(service: SamplerService, host: str = "127.0.0.1",
                     port: int = 8000, info: Optional[dict] = None):
    """Build (not start) a ThreadingHTTPServer exposing the service.

    Routes: ``GET /healthz``, ``GET /info``, ``GET /metrics``,
    ``POST /sample`` with JSON
    ``{num, label?, method?, steps?, eta?, guidance?, mode?, seed?,
    format?}``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    info = dict(info or {})
    dev = service.device
    health = {"status": "ok", "backend": dev.type,
              "devices": torch.cuda.device_count() if dev.type == "cuda"
              else 1}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):      # quiet; metrics replace access logs
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, health)
            elif self.path == "/info":
                superposed = service._model2 is not None
                methods = [m for m in _METHODS
                           if m != "superdiff" or superposed]
                self._json(200, {
                    "resolution": service.resolution,
                    "batch_size": service.batch_size,
                    "t_spacing": service._t_spacing,
                    "clip_x0": service._clip_x0,
                    "methods": methods,
                    "superdiff_modes": list(_SD_MODES) if superposed else [],
                    "conditional": service._conditional, **info})
            elif self.path == "/metrics":
                with service._lock:
                    stats = dict(service.stats)
                self._json(200, stats)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/sample":
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                spec = SampleSpec(
                    method=body.get("method", "ddim"),
                    steps=int(body.get("steps",
                                       50 if body.get("method", "ddim")
                                       != "dpmpp" else 10)),
                    eta=float(body.get("eta", 0.0)),
                    guidance=float(body.get("guidance", 1.0)),
                    mode=body.get("mode", "or"))
                req = service.sample_request(
                    int(body.get("num", 1)),
                    label=body.get("label"),
                    spec=spec, seed=body.get("seed"))
                imgs = req.result
                fmt = body.get("format", "png")
                data, ctype = encode_images(imgs, fmt)
                payload = {"num": int(imgs.shape[0]),
                           "shape": list(imgs.shape),
                           "content_type": ctype, "data": data}
                if req.logq is not None:
                    # per-sample Itô log-densities under each model — the
                    # superposition diagnostic (which model "owns" a sample)
                    payload["logq"] = [[float(v) for v in row]
                                       for row in req.logq]
                self._json(200, payload)
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": str(e)})
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
            except Exception as e:
                # device/runtime failures (a failed capture, CUDA OOM, ...)
                # must surface as a 5xx JSON error, not a dropped socket
                _log.exception("/sample failed")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
