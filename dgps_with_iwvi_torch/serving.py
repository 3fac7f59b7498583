"""Batched scoring on the card, live and from an exported artifact
(port of dgps_with_iwvi_tpu/serving.py).

``make_scorer_fn`` closes the one-propagate serving pair
(``models.predict_y_and_log_density``) over a model, optionally mapping
raw-unit inputs and outputs through the train split's normalization
statistics. ``Scorer.score`` scores a table in fixed-size batches on the
card through the hand kernels and returns ``mean`` / ``var`` /
``log_density`` on the host.

``export_scorer`` freezes the scorer (parameters, the Kuu factors, the
S-sample mixture predictive and optionally the statistics) into a
``torch.export.ExportedProgram``; ``save_scorer`` writes it to one file
and ``load_scorer`` reads it back as a ``ServingArtifact``, which scores
tables without the model-building code, the checkpoint or the flags.
The program's signature is fixed::

    score(X[B, d_in] f32, Y[B, d_out] f32, seed int64[]) -> (mean, var, log_density)

with raw-unit inputs and outputs when statistics were baked in. Y feeds
the log-density (and a switched Gaussian's task column); pass zeros when
targets are unknown. d_out is Y's width; the mean and variance have the
model's output width, ``d_mean`` in the meta: C class probabilities for a
multiclass or softmax model, whose Y is one label column.

The artifact holds stock ATen ops only, as the reference's holds no
Mosaic call: it is traced under ``ops.hopper.build.plain_versions()``
with ``serve_pallas`` and ``use_pallas`` off, since a ctypes launch cannot
be traced and an artifact must load without the package's kernels. The
live path keeps them. A program bakes the device of the tensors it
creates, so an artifact for several devices holds one program for each.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import zipfile
from typing import Sequence

import numpy as np
import torch

from .device import resolve_device
from .models import predict_y_and_log_density
from .models.dgp import prefactor_gp_layers
from .models.layers import GPLayerConfig, LVLayerConfig
from .ops.hopper import build
from .ops.hopper.conditional import philox_normal
from .ops.precision import f32_reductions
from .params import params_to_device
from .utils import graphs
from .utils.trace import span

_FORMAT_VERSION = 1
_EXAMPLE_ROWS = 16  # batch of the example inputs of a polymorphic export


@dataclasses.dataclass(frozen=True)
class NormalizationStats:
    """Train-split standardization statistics: X and Y standardized by the
    train mean/std; log-densities reported in raw y units by subtracting
    sum(log y_std)."""

    x_mean: np.ndarray  # [1, d_in] (any broadcastable shape)
    x_std: np.ndarray
    y_mean: np.ndarray  # [1, d_out]
    y_std: np.ndarray

    @classmethod
    def from_dataset(cls, data) -> "NormalizationStats":
        """From a ``data.Dataset`` (X_mean, X_std, Y_mean, Y_std)."""
        return cls(
            x_mean=np.asarray(data.X_mean, np.float32).reshape(1, -1),
            x_std=np.asarray(data.X_std, np.float32).reshape(1, -1),
            y_mean=np.asarray(data.Y_mean, np.float32).reshape(1, -1),
            y_std=np.asarray(data.Y_std, np.float32).reshape(1, -1),
        )


def make_scorer_fn(params, config, num_samples: int,
                   stats: NormalizationStats | None = None, *,
                   device="cuda", factors: dict | None = None):
    """``score(xb, yb, seed, eps=None) -> (mean, var, log_density)``.

    With ``stats``, inputs are raw units and outputs are mapped back
    (mean * y_std + y_mean, var * y_std^2, ld - sum(log y_std)); the
    statistics are float32, as in the reference. The noise comes from a
    torch generator seeded with ``seed`` (or from ``seed`` itself where it
    is a ``torch.Generator``), or from ``eps`` (per layer, see
    ``models.dgp.propagate``). factors: Kuu factors from
    ``prefactor_gp_layers`` to reuse for every call (else each call
    factors Kuu)."""
    device = resolve_device(device)
    params = params_to_device(params, device)
    if stats is not None:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        x_mean, x_std = f32(stats.x_mean), f32(stats.x_std)
        y_mean, y_std = f32(stats.y_mean), f32(stats.y_std)
        log_sigma = float(np.sum(np.log(np.asarray(stats.y_std, np.float64))))

    def score(xb: torch.Tensor, yb: torch.Tensor, seed,
              eps: Sequence | None = None):
        if stats is not None:
            xb = (xb - x_mean) / x_std
            yb = (yb - y_mean) / y_std
        gen = (None if eps is not None else seed
               if isinstance(seed, torch.Generator) else
               torch.Generator(device=device).manual_seed(int(seed)))
        (m, v), ld = predict_y_and_log_density(
            params, config, xb, yb, gen, num_samples, eps=eps,
            factors=factors)
        if stats is not None:
            m = m * y_std + y_mean
            v = v * torch.square(y_std)
            ld = ld - log_sigma
        return m, v, ld

    return score


class GraphedScore:
    """``make_scorer_fn``'s ``score`` replayed from CUDA graphs on the card
    (``utils.graphs``), as the reference jits its scorer: one graph per
    batch shape and policy, each drawing from one registered generator
    that is seeded with the call's seed before it runs, so that a replayed
    batch equals the eager call for that seed. ``stage(rows)`` is the
    static input [rows, d_in + d_y] of a shape, which ``score_table``
    fills from its pinned table; a batch given elsewhere is copied in.
    The outputs are the graph's own tensors, overwritten by the next call
    of the same shape. ``graphs`` is the ``utils.graphs.GraphCache``."""

    def __init__(self, fn, d_in: int, d_y: int, device):
        self.d_in, self.d_y = d_in, d_y
        self.device = torch.device(device)
        self._fn = fn
        self._gen = torch.Generator(device=self.device)
        self.graphs = graphs.GraphCache(self.device, (self._gen,))
        self._inputs: dict = {}

    def stage(self, rows: int) -> torch.Tensor:
        batch = self._inputs.get(rows)
        if batch is None:
            batch = self._inputs[rows] = torch.zeros(
                (rows, self.d_in + self.d_y), dtype=torch.float32,
                device=self.device)
        return batch

    def __call__(self, xb: torch.Tensor, yb: torch.Tensor, seed: int):
        rows, d_in = xb.shape[0], self.d_in
        batch = self.stage(rows)
        if xb.data_ptr() != batch.data_ptr():
            batch[:, :d_in].copy_(xb)
            batch[:, d_in:].copy_(yb)
        self._gen.manual_seed(int(seed))
        return self.graphs((rows,), lambda: self._fn(
            batch[:, :d_in], batch[:, d_in:], self._gen))


def label_width(config) -> int:
    """Columns of Y that a model reads: one label column for multiclass
    and softmax, the targets and the task index for switched_gaussian,
    else one per output."""
    d_out = config.layers[-1].d_out  # DGPConfig: a GP layer
    if config.likelihood in ("multiclass", "softmax"):
        return 1
    if config.likelihood == "switched_gaussian":
        return d_out + 1
    return d_out


def score_table(call, X, Y, d_in: int, d_y: int, batches, device, *,
                d_mean: int | None = None, depth: int | None = None,
                transport: str = "float32",
                transport_in: str = "float32", stage=None) -> dict:
    """The batch loop that ``Scorer``, ``ServingArtifact`` and the serve
    CLI share. X [n, d_in] and Y [n, d_y] (or None: zeros, and no
    log_density) form one host table, zero-padded past n; the mean and
    variance have ``d_mean`` columns (default d_y); batch i of
    `batches` (start, rows, keep) sends rows [start, start + rows) to
    ``call(i, xb, yb) -> (mean, var, log_density)`` and keeps its first
    `keep` results. Returns {"mean", "var"[, "log_density"]} as float32
    numpy arrays.

    On the card the table is uploaded from pinned memory without
    blocking: a pageable copy would hold the host until the card finished
    the batch before, so the host could not queue the next batch's
    launches meanwhile. ``depth`` bounds the batches in flight (before
    queueing batch i the host waits for batch i - depth, by a CUDA
    event; None: no bound). ``transport_in`` is the dtype the table
    crosses to the device in, upcast to float32 there (it rounds the
    inputs); ``transport`` the dtype the results cross back in, cast on
    the device (it rounds the delivered values only). Results come back
    in one copy. ``stage(rows)``, where given, is the float32 device
    buffer [rows, d_in + d_y] that a batch is copied into (a CUDA graph's
    static input, ``GraphedScore.stage``); else each batch is a new
    tensor. Each step of the loop is a span of ``utils.trace``
    (``serving.table``, ``.pin``, ``.upload``, ``.batch``, ``.copyback``,
    ``.unpack``)."""
    d_out = d_y if d_mean is None else d_mean
    with span("serving.table"):
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        if X.ndim != 2 or X.shape[1] != d_in:
            raise ValueError(f"X must be [n, {d_in}], got {X.shape}")
        have_y = Y is not None
        if have_y:
            Y = np.asarray(Y, np.float32)
            if Y.shape != (n, d_y):
                raise ValueError(f"Y must be [{n}, {d_y}] to match X and "
                                 f"the scorer's labels, got {Y.shape}")
        rows = max(start + size for start, size, _ in batches)
        table = np.zeros((rows, d_in + d_y), np.float32)
        table[:n, :d_in] = X
        if have_y:
            table[:n, d_in:] = Y
        host = torch.from_numpy(table).to(getattr(torch, transport_in))
    on_card = device.type == "cuda"
    if on_card:
        with span("serving.pin"):
            host = host.pin_memory()
    out_dt = getattr(torch, transport)
    outs, done = [], []
    with torch.no_grad(), f32_reductions():
        for i, (start, size, keep) in enumerate(batches):
            if depth is not None and len(done) >= depth:
                done[len(done) - depth].synchronize()
            with span("serving.upload"):
                src = host[start:start + size]
                if stage is None:
                    batch = src.to(device, non_blocking=True).float()
                else:
                    batch = stage(size).copy_(src, non_blocking=True)
            with span("serving.batch"):
                m, v, ld = call(i, batch[:, :d_in], batch[:, d_in:])
                outs.append(torch.cat([m[:keep], v[:keep], ld[:keep, None]],
                                      1).to(out_dt))
            if on_card and depth is not None:
                done.append(torch.cuda.Event())
                done[-1].record()
        with span("serving.copyback"):
            res = torch.cat(outs).cpu().float().numpy()
    with span("serving.unpack"):
        out = {"mean": np.ascontiguousarray(res[:, :d_out]),
               "var": np.ascontiguousarray(res[:, d_out:2 * d_out])}
        if have_y:
            out["log_density"] = np.ascontiguousarray(res[:, 2 * d_out])
    return out


def fixed_batches(n: int, size: int) -> list:
    """(start, rows, keep) of fixed-size batches over n rows, the last
    one padded."""
    return [(start, size, min(size, n - start))
            for start in range(0, n, size)]


class Scorer:
    """Scores arbitrary-length tables in fixed-size batches on the card,
    each batch one replay of a CUDA graph (``GraphedScore``); on the CPU
    eagerly."""

    def __init__(self, params, config, num_samples: int,
                 stats: NormalizationStats | None = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        first = config.layers[0]
        self.d_in = first.d_x if (isinstance(first, LVLayerConfig)
                                  and first.d_x > 0) else first.d_in
        self.d_out = config.layers[-1].d_out  # DGPConfig: a GP layer
        self.d_y = label_width(config)
        self._fn = make_scorer_fn(params, config, num_samples, stats,
                                  device=self.device)
        self._graphed = (GraphedScore(self._fn, self.d_in, self.d_y,
                                      self.device)
                         if self.device.type == "cuda" else None)

    def score(self, X, Y=None, *, seed: int = 0,
              max_batch: int = 8192) -> dict:
        """X [n, d_in] (and Y [n, d_y], or None: log_density omitted) ->
        {"mean", "var" [n, d_out][, "log_density" [n]]} as float32 numpy
        arrays. A switched Gaussian reads each point's task from Y, so it
        needs Y.

        Batch i uses seed + i; a short last batch is padded to max_batch,
        so every call runs at one shape (``score_table``)."""
        with span("serving.score"):
            if Y is None and self.config.likelihood == "switched_gaussian":
                raise ValueError("a switched_gaussian model needs the "
                                 "task-tagged Y to score")
            fn, stage = self._fn, None
            if self._graphed is not None:
                fn, stage = self._graphed, self._graphed.stage
            return score_table(
                lambda i, xb, yb: fn(xb, yb, seed + i), X, Y, self.d_in,
                self.d_y, fixed_batches(len(X), max_batch), self.device,
                d_mean=self.d_out, stage=stage)


def artifact_noise(seed, config, num_samples: int, batch: int,
                   device=None) -> list:
    """The per-layer noise an exported scorer draws for one batch (the
    ``eps`` of ``models.dgp.propagate``): layer i's [S, B, d] standard
    normals are ``philox_normal`` under the int64 `seed` on stream i, with
    point b's S*d draws in counter row b. A point's noise so depends on
    (seed, layer, b) alone and not on the batch size: padding a batch
    leaves its real rows' noise as it was. The final GP layer draws none.

    This is the port's Philox stream, not the reference's threefry, so an
    artifact's draws for one seed differ from the reference artifact's,
    as the live ``Scorer``'s generator draws do. The function traces
    (plain int64 tensor ops), so it runs inside the exported program."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    noise = []
    for i, cfg in enumerate(config.layers):
        if isinstance(cfg, GPLayerConfig) and cfg.final:
            noise.append(None)
            continue
        d = cfg.d_w if isinstance(cfg, LVLayerConfig) else cfg.d_out
        e = philox_normal(seed, batch, num_samples * d, seed.device,
                          stream=i)
        noise.append(e.reshape(batch, num_samples, d).transpose(0, 1))
    return noise


class _ExportedScorer(torch.nn.Module):
    """The traced scorer: ``make_scorer_fn`` fed ``artifact_noise``."""

    def __init__(self, fn, config, num_samples: int):
        super().__init__()
        self.fn, self.config, self.num_samples = fn, config, num_samples

    def forward(self, X, Y, seed):
        eps = artifact_noise(seed, self.config, self.num_samples,
                             X.shape[0], X.device)
        return self.fn(X, Y, seed, eps=eps)


def _tree_device(tree) -> torch.device:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree.device


def export_scorer(params, config, *, batch_size: int | str, d_in: int,
                  d_out: int, num_samples: int,
                  stats: NormalizationStats | None = None,
                  platforms: tuple[str, ...] | None = None):
    """Trace the scorer with ``torch.export``. Returns the
    ``ExportedProgram``, or for several platforms a dict {device type:
    ExportedProgram} in their order.

    ``platforms``: torch device types, ("cuda",), ("cpu",) or ("cuda",
    "cpu"); None means the device the params are on. Each device gets its
    own program, traced from the params and Kuu factors on that device.

    ``batch_size`` may be an int (a fixed-batch program; short tails pad
    to the full batch) or the string "b": a symbolic batch dimension, so
    that one program scores any n with no padding. The exported range of
    that dimension starts at 2 (``torch.export`` specializes sizes 0 and
    1); ``ServingArtifact.score`` pads a 1-row tail to 2.

    The Kuu factors are computed once, before the trace, and baked in as
    constants, which keeps the jitter ladder's choice out of the graph."""
    config = dataclasses.replace(config, serve_pallas=False,
                                 use_pallas=False)
    if platforms is None:
        platforms = (_tree_device(params).type,)
    poly = isinstance(batch_size, str)
    rows = _EXAMPLE_ROWS if poly else int(batch_size)
    dynamic = (({0: torch.export.Dim.DYNAMIC}, {0: torch.export.Dim.DYNAMIC},
                None) if poly else None)
    programs = {}
    for platform in platforms:
        device = resolve_device(platform)
        dev_params = params_to_device(params, device)
        with torch.no_grad(), build.plain_versions():
            factors = prefactor_gp_layers(dev_params, config)
            module = _ExportedScorer(
                make_scorer_fn(dev_params, config, num_samples, stats,
                               device=device, factors=factors),
                config, num_samples)
            example = (torch.zeros((rows, d_in), device=device),
                       torch.zeros((rows, d_out), device=device),
                       torch.zeros((), dtype=torch.int64, device=device))
            programs[device.type] = torch.export.export(
                module, example, dynamic_shapes=dynamic)
    if len(programs) == 1:
        return next(iter(programs.values()))
    return programs


def _input_values(program) -> list:
    """The fake tensors of a program's user inputs (X, Y, seed)."""
    names = set(program.graph_signature.user_inputs)
    return [node.meta["val"] for node in program.graph.nodes
            if node.op == "placeholder" and node.name in names]


def _output_values(program) -> list:
    """The fake tensors of a program's outputs (mean, var, log_density)."""
    (out,) = [node for node in program.graph.nodes if node.op == "output"]
    return [node.meta["val"] for node in out.args[0]]


def _program_name(platform: str) -> str:
    return f"program_{platform}.b64"


def save_scorer(path: str, exported, *, num_samples: int,
                has_stats: bool, extra_meta: dict | None = None) -> dict:
    """Write the program (or {device type: program}) and its JSON meta to
    one file at exactly `path`, by ``torch.export.save``. The CPU program,
    where there is one, is the file's own program, so that a host without
    a card can load the file; each other device's program is a saved
    program of its own, base64 in an extra file. Returns the meta dict."""
    programs = exported if isinstance(exported, dict) else {
        _input_values(exported)[0].device.type: exported}
    x, y, _ = _input_values(next(iter(programs.values())))
    poly = not isinstance(x.shape[0], int)
    meta = {
        "format_version": _FORMAT_VERSION,
        # polymorphic artifacts record batch_size=0 ("any")
        "batch_size": 0 if poly else int(x.shape[0]),
        "polymorphic_batch": poly,
        "d_in": int(x.shape[1]),
        "d_out": int(y.shape[1]),
        "d_mean": int(_output_values(next(iter(programs.values())))[0]
                      .shape[1]),
        "num_samples": int(num_samples),
        "raw_units": bool(has_stats),
        "platforms": list(programs),
        **(extra_meta or {}),
    }
    main = "cpu" if "cpu" in programs else next(iter(programs))
    extra = {"meta.json": json.dumps(meta)}
    for platform, program in programs.items():
        if platform != main:
            buf = io.BytesIO()
            torch.export.save(program, buf)
            extra[_program_name(platform)] = base64.b64encode(
                buf.getvalue()).decode("ascii")
    # a file object, so that the artifact lands at exactly `path`
    with open(path, "wb") as f:
        torch.export.save(programs[main], f, extra_files=extra)
    return meta


def _extra_file(archive: zipfile.ZipFile, name: str) -> str | None:
    for entry in archive.namelist():
        if entry.endswith(f"/extra/{name}"):
            return archive.read(entry).decode("utf-8")
    return None


def load_scorer(path: str, device="cuda") -> "ServingArtifact":
    """The artifact at `path`, with its program for `device` (the card
    unless the caller asks for the CPU). Raises ValueError for an unknown
    format version or a device the artifact has no program for."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as archive:
        raw = _extra_file(archive, "meta.json")
        meta = json.loads(raw) if raw is not None else {}
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unknown serving-artifact version in {path}: "
                             f"{meta.get('format_version')}")
        if device.type not in meta["platforms"]:
            raise ValueError(f"{path} holds programs for "
                             f"{meta['platforms']}, not for {device.type}")
        encoded = _extra_file(archive, _program_name(device.type))
    if encoded is None:
        with open(path, "rb") as f:
            encoded_bytes = f.read()
    else:
        encoded_bytes = base64.b64decode(encoded)
    program = torch.export.load(io.BytesIO(encoded_bytes))
    return ServingArtifact(program, meta)


class ServingArtifact:
    """A loaded scorer: the exported program of one device, and its
    batched, pipelined scoring loop."""

    def __init__(self, exported, meta: dict):
        self.exported = exported
        self.meta = meta
        self.device = _input_values(exported)[0].device
        self._fn = exported.module()

    def score(self, X, Y=None, *, seed: int = 0, depth: int = 8,
              max_batch: int = 8192, transport: str = "float32",
              transport_in: str = "float32") -> dict:
        """Score an arbitrary-length table -> {"mean", "var"[,
        "log_density"]} as float32 numpy arrays.

        Fixed-batch artifacts run fixed-size batches, the tail padded with
        zero rows. Polymorphic-batch artifacts run ``max_batch``-row chunks
        and one tail at its own size (a 1-row tail padded to 2, where the
        exported range starts). Batch i uses seed + i; a point's noise
        does not depend on the padding (``artifact_noise``).

        X: [n, d_in]; Y: [n, d_out] or None (log_density omitted). Units
        are raw when the artifact was exported with stats, else the
        caller's. ``transport`` ('float32' | 'bfloat16' | 'float16'),
        ``transport_in`` ('float32' | 'bfloat16') and ``depth``: see
        ``score_table``."""
        poly = self.meta.get("polymorphic_batch", False)
        n = len(X)
        if poly:  # natural-size chunks; a 1-row tail scores as 2 rows
            batches = [(start, max(min(max_batch, n - start), 2),
                        min(max_batch, n - start))
                       for start in range(0, n, max_batch)]
        else:
            batches = fixed_batches(n, self.meta["batch_size"])
        seeds = torch.arange(seed, seed + len(batches), dtype=torch.int64)
        seeds = (seeds.pin_memory() if self.device.type == "cuda"
                 else seeds).to(self.device, non_blocking=True)
        return score_table(
            lambda i, xb, yb: self._fn(xb, yb, seeds[i]), X, Y,
            self.meta["d_in"], self.meta["d_out"], batches, self.device,
            d_mean=self.meta.get("d_mean"), depth=depth,
            transport=transport, transport_in=transport_in)
