"""Training-quality observability: tensor statistics, fingerprints, NaN/Inf
provenance and loss health, the port of ``serverless_learn_tpu/telemetry/
numerics.py``.

Everything here is math over trees of tensors that the step, the auditor
(``training/audit.py``), the health engine, the exporter and the CLI share:

* **Step statistics** (:func:`tree_stats`, :func:`step_summary`,
  :func:`global_norm`, :class:`StepNumerics`): per-subtree grad, param and
  update L2 norms, RMS, absmax, update-to-param ratios and non-finite
  counts. The reference computes them inside its jitted step, where XLA
  fuses them into the backward; here the hand-written reduction kernels of
  ``ops/tensor_stats.py`` read each tensor once on the card, and the step's
  statistics stay there as one stacked tensor (:class:`NumericsSummary`)
  that the auditor fetches only at its cadence.
* **Fingerprints** (:func:`fingerprint`, :func:`diff_fingerprints`,
  :func:`diff_fingerprint_logs`): per-subtree digests (L2, sum, absmax and
  ``chunks`` positional partial sums); two trails bisect to the first step
  and the first subtree that diverged. The port's trails and the JAX
  package's read each other.
* **Non-finite provenance** (:func:`first_nonfinite`,
  :func:`nonfinite_provenance`): the first parameter leaf holding a NaN or
  an inf, then a forward sweep with hooks on every named module that names
  the first module whose output is non-finite.
* **Parity harness** (:class:`ParityHarness`, :func:`compare_trees`).
* **Loss-health detectors** (:class:`LossHealth`) over the per-step record
  ring (:func:`note_step`), which the health engine turns into the
  ``numerics.*`` alerts.

Trees are nested dicts (lists and tuples by index), flattened as
``jax.tree_util`` flattens them: dict keys in sorted order, so a subtree's
leaves, the subtrees themselves (``layer_10`` before ``layer_2``) and the
answer of :func:`first_nonfinite` come in the reference's order. The port's
parameters enter under their flax paths (``bridge.to_flax``, or
``bridge.nest`` of the state dict: the element order of the port's
``[I, O]`` kernels is flax's).
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from serverless_learn_tpu_torch.ops.tensor_stats import (
    ABSMAX, CHUNK0, INF, KCOLS, MAX_CHUNKS, NAN, SUM, SUMSQ, SUMSQ_ALL,
    grid_for, stats_reduce, tensor_stats, tensor_stats_many)
from serverless_learn_tpu_torch.telemetry.health import EwmaMad

DEFAULT_CHUNKS = 4
DEFAULT_DEPTH = 1


# -- trees --------------------------------------------------------------------


def tree_flatten_with_path(tree) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order: dicts by sorted key,
    lists and tuples by index; None is an empty subtree."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path: ``['layer_0']['attn'][0]``."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def _subtree_name(path, depth: int) -> str:
    """Dotted name of the first ``depth`` path entries ("layer_0",
    "layer_2.attn"). Leaves above the depth fold into their parent."""
    parts = [str(e) for e in path[:depth]]
    return ".".join(parts) if parts else "root"


def subtrees(tree, depth: int = DEFAULT_DEPTH) -> Dict[str, List[Any]]:
    """Group a tree's leaves by their ``depth``-level subtree name, in
    flatten order."""
    out: Dict[str, List[Any]] = {}
    for path, leaf in tree_flatten_with_path(tree):
        out.setdefault(_subtree_name(path, depth), []).append(leaf)
    return out


def _tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor (numpy arrays and Python numbers on the CPU)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":  # ml_dtypes' bfloat16, for one
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() or leaf.is_complex()
    return np.asarray(leaf).dtype.kind in "fc" or \
        np.asarray(leaf).dtype.name == "bfloat16"


# -- the reduction plan -------------------------------------------------------


class StatsPlan:
    """Where the statistics of a list of tensors go: ``groups`` is a list of
    (name, [numel of each tensor]) with the tensors in flatten order. Each
    tensor's rows follow its group's earlier tensors', and its first
    element's index in the group places it among the group's ``chunks``
    positional chunks of ``ceil(n / chunks)`` elements (the reference's
    padded reshape). :meth:`collect` runs ``ops.tensor_stats`` on one
    tensor, :meth:`finish` ``ops.stats_reduce`` on all of them: a table of
    one f64 row of ``KCOLS`` statistics a group, on the tensors' device."""

    def __init__(self, groups: Sequence[Tuple[str, Sequence[int]]],
                 chunks: int = 0):
        if not 0 <= chunks <= MAX_CHUNKS:
            raise ValueError(f"numerics.chunks must be in [0, {MAX_CHUNKS}],"
                             f" got {chunks}")
        self.names = [name for name, _ in groups]
        self.counts = [int(sum(sizes)) for _, sizes in groups]
        self.chunks = chunks
        self.chunk = [max(1, -(-n // chunks)) if chunks else 0
                      for n in self.counts]
        self.leaves: List[Tuple[int, int, int, int]] = []  # g, row, base, n
        bounds, row = [0], 0
        for g, (_, sizes) in enumerate(groups):
            base = 0
            for n in sizes:
                self.leaves.append((g, row, base, int(n)))
                row += grid_for(int(n))
                base += int(n)
            bounds.append(row)
        self.rows, self.bounds = row, bounds
        self._bounds_on: Dict[torch.device, torch.Tensor] = {}
        self._sqrt_on: Dict[torch.device, torch.Tensor] = {}

    def new_rows(self, device) -> torch.Tensor:
        return torch.empty(max(self.rows, 1), KCOLS, dtype=torch.float64,
                           device=device)

    def collect(self, rows: torch.Tensor, j: int, x: torch.Tensor,
                scale: float = 1.0, chunks: bool = True,
                stream: Optional[int] = None):
        """Tensor ``j``'s statistics (of ``scale * x``) into ``rows``, in a
        launch of its own (``stream``: the CUDA stream handle, to spare
        looking it up at every call)."""
        g, r0, base, n = self.leaves[j]
        if x.numel() != n:
            raise ValueError(f"tensor {j} of group {self.names[g]!r} has "
                             f"{x.numel()} elements, the plan {n}")
        if not x.is_contiguous():
            x = x.contiguous()
        use = self.chunks if chunks else 0
        tensor_stats(x, rows, row0=r0, base=base,
                     chunk=self.chunk[g] if use else 0, chunks=use,
                     scale=scale, stream=stream)

    def collect_all(self, rows: torch.Tensor, leaves: Sequence[torch.Tensor],
                    scale: float = 1.0, chunks: bool = True):
        """Every tensor's statistics (in plan order) into ``rows``, in one
        launch where they lie on the card."""
        if len(leaves) != len(self.leaves):
            raise ValueError(f"{len(leaves)} tensors for a plan of "
                             f"{len(self.leaves)}")
        xs = [x if x.is_contiguous() else x.contiguous() for x in leaves]
        for x, (g, _, _, n) in zip(xs, self.leaves):
            if x.numel() != n:
                raise ValueError(f"a tensor of group {self.names[g]!r} has "
                                 f"{x.numel()} elements, the plan {n}")
        use = self.chunks if chunks else 0
        tensor_stats_many(xs, rows, [r0 for _, r0, _, _ in self.leaves],
                          [b for _, _, b, _ in self.leaves],
                          [self.chunk[g] or 1 for g, _, _, _ in self.leaves],
                          chunks=use, scale=scale)

    def sqrt_n(self, device) -> torch.Tensor:
        """sqrt(max(n, 1)) of each group's element count, f32 on ``device``
        (made once: a copy to the card would wait for it)."""
        t = self._sqrt_on.get(device)
        if t is None:
            t = self._sqrt_on[device] = torch.tensor(
                [math.sqrt(max(n, 1)) for n in self.counts],
                dtype=torch.float32).to(device)
        return t

    def finish(self, rows: torch.Tensor) -> torch.Tensor:
        dev = rows.device
        bounds = self._bounds_on.get(dev)
        if bounds is None:
            bounds = torch.tensor(self.bounds, dtype=torch.int64, device=dev)
            self._bounds_on[dev] = bounds
        out = torch.empty(len(self.names), KCOLS, dtype=torch.float64,
                          device=dev)
        return stats_reduce(rows, bounds, out)

    def run(self, leaves: Sequence[torch.Tensor], scale: float = 1.0,
            chunks: bool = True) -> torch.Tensor:
        """Collect every tensor (in plan order) and finish."""
        rows = self.new_rows(leaves[0].device)
        self.collect_all(rows, leaves, scale, chunks)
        return self.finish(rows)


def _plan_tree(tree, depth: int, chunks: int = 0
               ) -> Tuple[StatsPlan, List[torch.Tensor]]:
    subs = {name: [_tensor(leaf) for leaf in leaves]
            for name, leaves in subtrees(tree, depth).items()}
    plan = StatsPlan([(name, [t.numel() for t in ts])
                      for name, ts in subs.items()], chunks)
    return plan, [t for ts in subs.values() for t in ts]


def _table(tree, depth: int, chunks: int = 0):
    plan, leaves = _plan_tree(tree, depth, chunks)
    if not leaves:
        return plan, None
    return plan, plan.run(leaves)




# -- step statistics ----------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over all float leaves, in f32 (a 0-dim tensor on
    the leaves' device)."""
    leaves = [_tensor(l) for _, l in tree_flatten_with_path(tree)
              if _is_float(l)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    plan = StatsPlan([("all", [t.numel() for t in leaves])])
    return plan.run(leaves)[0, SUMSQ_ALL].float().sqrt()


def _sub_stats(table: torch.Tensor, sqrt_n: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """[G] vectors l2 / rms / absmax (f32) and nonfinite (f64) of a table;
    ``sqrt_n``: the plan's ``sqrt_n``."""
    l2 = table[:, SUMSQ].float().sqrt()
    return {"l2": l2, "rms": l2 / sqrt_n,
            "absmax": table[:, ABSMAX].float(),
            "nonfinite": table[:, NAN] + table[:, INF]}


def tree_stats(tree, depth: int = DEFAULT_DEPTH
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-subtree {l2, rms, absmax, nonfinite} of 0-dim tensors: non-finite
    values are left out of the norms (the flag carries the incident, the
    norms stay comparable across steps)."""
    plan, table = _table(tree, depth)
    if table is None:
        return {}
    st = _sub_stats(table, plan.sqrt_n(table.device))
    return {name: {"l2": st["l2"][g], "rms": st["rms"][g],
                   "absmax": st["absmax"][g],
                   "nonfinite": st["nonfinite"][g].long()}
            for g, name in enumerate(plan.names)}


def _fp_of(table: torch.Tensor, chunks: int) -> torch.Tensor:
    """[G, 3 + chunks] f32: l2, sum, absmax, c0.. of each group."""
    cols = [table[:, SUMSQ].float().sqrt(), table[:, SUM].float(),
            table[:, ABSMAX].float()]
    cols += [table[:, CHUNK0 + i].float() for i in range(chunks)]
    return torch.stack(cols, dim=1)


def _fp_fields(chunks: int) -> List[str]:
    return ["l2", "sum", "absmax"] + [f"c{i}" for i in range(chunks)]


def fingerprint(tree, depth: int = DEFAULT_DEPTH,
                chunks: int = DEFAULT_CHUNKS
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-subtree reduced digest {l2, sum, absmax, c0..c(chunks-1)} of
    finite values: the chunk sums split the subtree's concatenated elements
    into ``chunks`` contiguous ranges, so a divergence confined to one
    weight block moves one of them."""
    chunks = max(chunks, 1)
    plan, table = _table(tree, depth, chunks)
    if table is None:
        return {}
    fp = _fp_of(table, chunks)
    fields = _fp_fields(chunks)
    return {name: {f: fp[g, i] for i, f in enumerate(fields)}
            for g, name in enumerate(plan.names)}


def fingerprint_record(tree, depth: int = DEFAULT_DEPTH,
                       chunks: int = DEFAULT_CHUNKS) -> Dict[str, dict]:
    """:func:`fingerprint` on the host in one transfer, each value rounded
    to 9 digits as the reference's records carry them."""
    chunks = max(chunks, 1)
    plan, table = _table(tree, depth, chunks)
    if table is None:
        return {}
    vals = _fp_of(table, chunks).cpu().tolist()
    fields = _fp_fields(chunks)
    return {name: {f: round(float(v), 9) for f, v in zip(fields, row)}
            for name, row in zip(plan.names, vals)}


def weight_version(tree, depth: int = DEFAULT_DEPTH,
                   chunks: int = DEFAULT_CHUNKS) -> Optional[str]:
    """Compact weight identity: the :func:`fingerprint` digest, floats at 6
    significant digits, hashed to 12 hex characters."""
    if tree is None:
        return None
    fp = fingerprint_record(tree, depth=depth, chunks=chunks)
    blob = json.dumps(
        {name: {k: f"{float(v):.6g}" for k, v in sorted(digest.items())}
         for name, digest in sorted(fp.items())}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


class NumericsSummary(Mapping):
    """A step's numerics output: the reference's flat dict of scalars, as
    one stacked f64 tensor on the card (``stacked``) and its keys; item
    ``k`` is a 0-dim view. :meth:`fetch` moves the whole of it to the host
    in one transfer."""

    def __init__(self, keys: List[str], stacked: torch.Tensor):
        self._keys = keys
        self._index = {k: i for i, k in enumerate(keys)}
        self.stacked = stacked

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.stacked[self._index[key]]

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def fetch(self) -> Dict[str, float]:
        return dict(zip(self._keys, self.stacked.cpu().tolist()))


def summary_keys(names: Sequence[str], chunks: int,
                 with_fingerprint: bool) -> List[str]:
    """The reference's keys of :func:`step_summary`, in its order."""
    keys = [f"grad/{n}/{k}" for n in names
            for k in ("l2", "rms", "absmax", "nonfinite")]
    keys += [f"param/{n}/{k}" for n in names
             for k in ("l2", "rms", "absmax", "nonfinite")]
    keys += [k for n in names for k in (f"update/{n}/l2", f"ratio/{n}")]
    if with_fingerprint:
        keys += [f"fp/{n}/{f}" for n in names for f in _fp_fields(chunks)]
    return keys + ["grad_norm", "param_norm", "update_norm", "update_ratio",
                   "nonfinite_total"]


def summarize(names: Sequence[str], sqrt_n: torch.Tensor,
              grads: torch.Tensor, params: torch.Tensor,
              updates: torch.Tensor, loss: Optional[torch.Tensor] = None,
              grad_norm: Optional[torch.Tensor] = None, chunks: int = 0,
              with_fingerprint: bool = True,
              keys: Optional[List[str]] = None) -> NumericsSummary:
    """The :class:`NumericsSummary` of three stats tables (one row a
    subtree, the same subtrees; ``sqrt_n`` the plan's): the reference's
    ``step_summary`` values. ``grad_norm`` defaults to the grads' unmasked
    global norm."""
    g = _sub_stats(grads, sqrt_n)
    p = _sub_stats(params, sqrt_n)
    u_l2 = updates[:, SUMSQ].float().sqrt()
    ratio = u_l2 / p["l2"].clamp_min(1e-12)
    parts = [torch.stack([g["l2"].double(), g["rms"].double(),
                          g["absmax"].double(), g["nonfinite"]], 1),
             torch.stack([p["l2"].double(), p["rms"].double(),
                          p["absmax"].double(), p["nonfinite"]], 1),
             torch.stack([u_l2, ratio], 1).double()]
    if with_fingerprint:
        parts.append(_fp_of(params, chunks).double())
    if grad_norm is None:
        grad_norm = grads[:, SUMSQ_ALL].sum().float().sqrt()
    param_norm = params[:, SUMSQ_ALL].sum().float().sqrt()
    update_norm = updates[:, SUMSQ_ALL].sum().float().sqrt()
    bad = (grads[:, NAN] + grads[:, INF]).sum() \
        + (params[:, NAN] + params[:, INF]).sum()
    if loss is not None:
        bad = bad + (~torch.isfinite(loss.detach().float())).sum().double()
    totals = torch.stack([grad_norm.float().reshape(()), param_norm,
                          update_norm,
                          update_norm / param_norm.clamp_min(1e-12)]).double()
    stacked = torch.cat([t.reshape(-1) for t in parts]
                        + [totals, bad.reshape(1)])
    keys = keys or summary_keys(names, chunks, with_fingerprint)
    return NumericsSummary(keys, stacked)


def step_summary(params, grads, updates, loss=None,
                 depth: int = DEFAULT_DEPTH, chunks: int = DEFAULT_CHUNKS,
                 with_fingerprint: bool = True) -> NumericsSummary:
    """The numerics of one optimizer step over three trees of the same
    structure: keys ``grad/<sub>/{l2,rms,absmax,nonfinite}``,
    ``param/<sub>/...``, ``update/<sub>/l2``, ``ratio/<sub>`` (update L2 /
    param L2), ``fp/<sub>/{l2,sum,absmax,c*}`` and the global
    ``grad_norm``, ``param_norm``, ``update_norm``, ``update_ratio``,
    ``nonfinite_total`` (grads + params + loss)."""
    chunks = max(chunks, 1)
    plan, leaves_p = _plan_tree(params, depth, chunks)
    _, leaves_g = _plan_tree(grads, depth)
    _, leaves_u = _plan_tree(updates, depth)
    tp = plan.run(leaves_p, chunks=True)
    tg = plan.run(leaves_g, chunks=False)
    tu = plan.run(leaves_u, chunks=False)
    loss = None if loss is None else torch.as_tensor(loss)
    return summarize(plan.names, plan.sqrt_n(tp.device), tg, tp, tu, loss,
                     None, chunks, with_fingerprint)


class StepNumerics:
    """The train step's numerics, computed where the reference's jitted step
    computes them but read from the live tensors: the gradients before the
    clipping (:meth:`grads`, one launch), each update where the optimizer
    forms it (:meth:`update`, the signed, lr-scaled update that optax
    returns, never kept as a copy; a launch a tensor) and the updated
    parameters (:meth:`summary`, one launch), which finishes the three
    tables and stacks the step's statistics on the card; nothing waits for
    the card.

    ``names`` are the trainable parameters' state-dict names (their flax
    paths) in the optimizer's order, ``sizes`` their element counts."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int],
                 depth: int = DEFAULT_DEPTH, chunks: int = DEFAULT_CHUNKS,
                 with_fingerprint: bool = True):
        order = sorted(range(len(names)), key=lambda i: tuple(
            names[i].split(".")))
        groups: Dict[str, List[int]] = {}
        for i in order:
            groups.setdefault(_subtree_name(tuple(names[i].split(".")),
                                            depth), []).append(i)
        self.chunks = max(chunks, 1) if with_fingerprint else 0
        self.with_fingerprint = with_fingerprint
        self.plan = StatsPlan([(g, [sizes[i] for i in idx])
                               for g, idx in groups.items()], self.chunks)
        # the plan's order of the optimizer's indices, and back
        self.order = [i for idx in groups.values() for i in idx]
        self.slot = {i: j for j, i in enumerate(self.order)}
        self._stream: Optional[int] = None
        self.keys = summary_keys(self.plan.names, max(chunks, 1),
                                 with_fingerprint)
        self._rows: Dict[str, torch.Tensor] = {}
        self._tables: Dict[str, torch.Tensor] = {}

    def _rows_of(self, tree: str, device) -> torch.Tensor:
        rows = self._rows.get(tree)
        if rows is None or rows.device != device:
            rows = self._rows[tree] = self.plan.new_rows(device)
        return rows

    def _ordered(self, tensors: Sequence[torch.Tensor]):
        return [tensors[i] for i in self.order]

    def grads(self, grads: Sequence[torch.Tensor]):
        """The gradients' statistics (one launch), before the optimizer."""
        rows = self._rows_of("grad", grads[0].device)
        self.plan.collect_all(rows, self._ordered(grads), chunks=False)
        self._tables["grad"] = self.plan.finish(rows)
        dev = grads[0].device
        self._stream = (torch.cuda.current_stream(dev).cuda_stream
                        if dev.type == "cuda" else None)

    def update(self, i: int, u: torch.Tensor, scale: float):
        """Parameter ``i``'s update is ``scale * u`` (one launch a tensor:
        ``u`` lives only inside the optimizer's loop)."""
        self.plan.collect(self._rows_of("update", u.device), self.slot[i], u,
                          scale=scale, chunks=False, stream=self._stream)

    def summary(self, loss: torch.Tensor, grad_norm: torch.Tensor,
                params: Sequence[torch.Tensor]) -> NumericsSummary:
        """Finish the step's statistics; ``params`` are the updated
        trainable parameters in the optimizer's order."""
        rows = self._rows_of("param", params[0].device)
        self.plan.collect_all(rows, self._ordered(params))
        tp = self.plan.finish(rows)
        tu = self.plan.finish(self._rows["update"])
        return summarize(self.plan.names, self.plan.sqrt_n(tp.device),
                         self._tables.pop("grad"), tp, tu, loss, grad_norm,
                         self.chunks, self.with_fingerprint, self.keys)


def replica_divergence(params) -> torch.Tensor:
    """Max over leaves of max |p_r - mean_r p| over stacked ``[R, ...]``
    leaves, in f32: 0 iff the replicas agree."""
    divs = [(t.float() - t.float().mean(0, keepdim=True)).abs().max()
            for t in (_tensor(l) for _, l in tree_flatten_with_path(params))]
    return torch.stack(divs).max() if divs else torch.zeros(())


# -- fingerprint diffing / bisection ------------------------------------------


def diff_fingerprints(fa: Dict[str, dict], fb: Dict[str, dict],
                      rtol: float = 1e-5, atol: float = 1e-6
                      ) -> Optional[dict]:
    """Compare two per-subtree digests; None when they agree within
    tolerance, else the worst-offending {subtree, field, a, b, rel_err}."""
    worst = None
    for name in sorted(set(fa) | set(fb)):
        da, db = fa.get(name), fb.get(name)
        if da is None or db is None:
            return {"subtree": name, "field": "(missing)",
                    "a": None if da is None else "present",
                    "b": None if db is None else "present",
                    "rel_err": float("inf")}
        for field in sorted(set(da) | set(db)):
            va, vb = float(da.get(field, 0.0)), float(db.get(field, 0.0))
            denom = max(abs(va), abs(vb), 1e-30)
            err = abs(va - vb)
            if err <= atol + rtol * denom:
                continue
            rel = err / denom
            if worst is None or rel > worst["rel_err"]:
                worst = {"subtree": name, "field": field,
                         "a": va, "b": vb, "rel_err": rel}
    return worst


def _fp_records(records: Sequence[dict]) -> Dict[int, dict]:
    """step -> fingerprint from mixed JSONL records (``numerics_fingerprint``
    records and ``numerics_stats`` records that embed an ``fp`` section);
    the last record of a step wins."""
    out: Dict[int, dict] = {}
    for rec in records:
        if rec.get("event") not in ("numerics_fingerprint",
                                    "numerics_stats"):
            continue
        fp = rec.get("fp")
        step = rec.get("step")
        if isinstance(fp, dict) and isinstance(step, int):
            out[step] = fp
    return out


def diff_fingerprint_logs(records_a: Sequence[dict],
                          records_b: Sequence[dict],
                          rtol: float = 1e-5, atol: float = 1e-6) -> dict:
    """Bisect two recorded fingerprint trails to the first step and the
    first parameter subtree that diverged: {"diverged", "first_divergent_
    step", "subtree", "field", "a", "b", "rel_err", "steps_compared",
    "last_agreeing_step"}. Steps present in only one trail are skipped."""
    fa, fb = _fp_records(records_a), _fp_records(records_b)
    common = sorted(set(fa) & set(fb))
    last_ok = None
    for step in common:
        worst = diff_fingerprints(fa[step], fb[step], rtol=rtol, atol=atol)
        if worst is not None:
            return {"diverged": True, "first_divergent_step": step,
                    "last_agreeing_step": last_ok,
                    "steps_compared": len(common), **worst}
        last_ok = step
    return {"diverged": False, "steps_compared": len(common),
            "last_agreeing_step": common[-1] if common else None,
            "only_a": len(set(fa) - set(fb)),
            "only_b": len(set(fb) - set(fa))}


def load_records(path: str) -> List[dict]:
    """Read a JSONL trail (tolerates a torn final line) or a flight dump."""
    out: List[dict] = []
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            try:
                obj = json.load(f)
                if isinstance(obj, dict):
                    if obj.get("event") == "flight_dump":
                        return [r for r in obj.get("events", [])
                                if isinstance(r, dict)]
                    return [obj]
            except json.JSONDecodeError:
                f.seek(0)
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


# -- non-finite provenance ----------------------------------------------------


def first_nonfinite(tree, depth: int = DEFAULT_DEPTH) -> Optional[dict]:
    """First (flatten-order) float leaf holding a NaN or an inf: {"path",
    "subtree", "nan", "inf", "shape"}; None when clean. Counted where the
    leaves lie (the stats kernel on the card), one transfer of the counts."""
    flat = [(path, _tensor(leaf)) for path, leaf
            in tree_flatten_with_path(tree) if _is_float(leaf)]
    counts: List[Tuple[float, float]] = [(0.0, 0.0)] * len(flat)
    by_dev: Dict[torch.device, List[int]] = {}
    for i, (_, t) in enumerate(flat):
        by_dev.setdefault(t.device, []).append(i)
    for idx in by_dev.values():
        plan = StatsPlan([(str(i), [flat[i][1].numel()]) for i in idx])
        table = plan.run([flat[i][1] for i in idx])[:, [NAN, INF]]
        for i, (nan, inf) in zip(idx, table.cpu().tolist()):
            counts[i] = (nan, inf)
    for (path, t), (nan, inf) in zip(flat, counts):
        if nan or inf:
            return {"path": keystr(path),
                    "subtree": _subtree_name(path, depth),
                    "nan": int(nan), "inf": int(inf),
                    "shape": list(t.shape)}
    return None


def _sweep(module: torch.nn.Module, params, x) -> Dict[str, dict]:
    """One forward of ``module`` on ``x`` (with ``params``, a flax tree, in
    place of its own parameters where given) with a hook on every named
    module: each output reduced on the module's device by the stats
    kernels; only the counts, sums of squares and maxima reach the host,
    in one transfer. Returns {layer: {"nan", "inf", "rms", "absmax"}} in
    call order; the whole model's output is ``__root__``."""
    from serverless_learn_tpu_torch.bridge import from_flax

    dev = next(module.parameters()).device
    seen: List[Tuple[str, int, torch.Tensor]] = []
    bounds: Dict[int, torch.Tensor] = {}

    def reduce(name, out):
        ts = (out if isinstance(out, (list, tuple)) else [out])
        for t in ts:
            if not isinstance(t, torch.Tensor) or not t.is_floating_point():
                continue
            t = t.detach()
            if not t.is_contiguous():
                t = t.contiguous()
            grid = grid_for(t.numel())
            rows = torch.empty(grid, KCOLS, dtype=torch.float64,
                               device=t.device)
            tensor_stats(t, rows)
            b = bounds.get(grid)
            if b is None:
                b = bounds[grid] = torch.tensor([0, grid], dtype=torch.int64,
                                                device=t.device)
            row = torch.empty(1, KCOLS, dtype=torch.float64,
                              device=t.device)
            seen.append((name, t.numel(), stats_reduce(rows, b, row)))

    handles = []
    try:
        for name, mod in module.named_modules():
            label = name.replace(".", "/") or "__root__"
            handles.append(mod.register_forward_hook(
                lambda m, i, o, label=label: reduce(label, o)))
        with torch.no_grad():
            x = x.to(dev)
            if params is None:
                module(x)
            else:
                named = {k: v.to(dev) for k, v in from_flax(params).items()}
                torch.func.functional_call(module, named, (x,))
    finally:
        for h in handles:
            h.remove()
    table = torch.cat([r for _, _, r in seen]).cpu() if seen else None
    out: Dict[str, dict] = {}
    for k, (name, n, _) in enumerate(seen):
        row = table[k]
        agg = out.setdefault(name, {"nan": 0, "inf": 0, "sq": 0.0, "n": 0,
                                    "absmax": 0.0})
        agg["nan"] += int(row[NAN])
        agg["inf"] += int(row[INF])
        agg["sq"] += float(row[SUMSQ])
        agg["n"] += n
        agg["absmax"] = max(agg["absmax"], float(row[ABSMAX]))
    return {name: {"nan": a["nan"], "inf": a["inf"],
                   "rms": math.sqrt(a["sq"] / max(a["n"], 1)),
                   "absmax": a["absmax"]} for name, a in out.items()}


def nonfinite_provenance(module, params, batch, model_state=None,
                         depth: int = DEFAULT_DEPTH) -> dict:
    """Name the first layer that produced a non-finite value.

    1. the params themselves (a flax tree): a NaN weight names its subtree
       directly;
    2. a forward sweep of ``module`` (the port's model, run with ``params``
       where given, else with its own): every named module's output is
       checked and the earliest non-finite one is named, with its RMS and
       absmax, so overflow (huge finite inputs giving inf) and 0/0-style
       NaNs tell apart.

    Returns {"first", "kind", "param", "intermediates", "activations"}:
    ``first`` is "params:<subtree>" or "intermediates:<layer>". Layers sort
    by name, the whole model's output last, as the reference's do."""
    report: dict = {"first": None, "kind": None, "param": None,
                    "intermediates": [], "activations": {}}
    bad_param = first_nonfinite(params, depth) if params is not None else None
    if bad_param is not None:
        report["param"] = bad_param
        report["first"] = f"params:{bad_param['subtree']}"
        report["kind"] = "nan" if bad_param["nan"] else "inf"
    if module is None:
        return report
    try:
        x = (next(iter(batch.values())) if isinstance(batch, dict)
             else batch)
        layers = _sweep(module, params, torch.as_tensor(x))
        rows = []
        for name, st in layers.items():
            report["activations"][name] = {"rms": st["rms"],
                                           "absmax": st["absmax"]}
            if st["nan"] or st["inf"]:
                rows.append({"layer": name, **st})
        # NaN/Inf propagates forward: the earliest bad layer by name (the
        # root output last) is the origin.
        rows.sort(key=lambda r: (r["layer"] == "__root__", r["layer"]))
        report["intermediates"] = rows
        if rows and report["first"] is None:
            report["first"] = f"intermediates:{rows[0]['layer']}"
            report["kind"] = "nan" if rows[0]["nan"] else "inf"
    except Exception as e:  # a broken model must not mask the incident
        report["sweep_error"] = f"{type(e).__name__}: {e}"
    return report


# -- parity harness -----------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def max_ulp_diff(a, b) -> int:
    """Max distance in units-in-the-last-place between two same-shape float
    arrays (0 = bitwise identical up to signed zero)."""
    a = _host(a)
    b = np.asarray(_host(b), a.dtype)
    if a.dtype == np.float64:
        ai = a.view(np.int64)
        bi = b.view(np.int64)
        bias = np.int64(1) << 63
    else:
        a = a.astype(np.float32)
        b = b.astype(np.float32)
        ai = a.view(np.int32)
        bi = b.view(np.int32)
        bias = np.int32(1) << 31
    ai = np.where(ai < 0, bias - ai, ai).astype(np.int64)
    bi = np.where(bi < 0, np.int64(bias) - bi, bi).astype(np.int64)
    both = np.isfinite(a) & np.isfinite(b)
    if not both.any():
        return 0 if (np.isfinite(a) == np.isfinite(b)).all() else 1 << 62
    return int(np.abs(ai - bi)[both].max(initial=0))


def compare_trees(a, b, depth: int = DEFAULT_DEPTH) -> Dict[str, dict]:
    """Per-subtree {max_abs_err, max_rel_err, max_ulp} between two trees of
    the same structure."""
    sa, sb = subtrees(a, depth), subtrees(b, depth)
    out: Dict[str, dict] = {}
    for name in sorted(set(sa) | set(sb)):
        la, lb = sa.get(name, []), sb.get(name, [])
        if len(la) != len(lb):
            out[name] = {"error": "structure mismatch"}
            continue
        max_abs = max_rel = 0.0
        max_ulp = 0
        for x, y in zip(la, lb):
            xh, yh = _host(x), _host(y)
            xa, ya = xh.astype(np.float64), yh.astype(np.float64)
            err = np.abs(xa - ya)
            max_abs = max(max_abs, float(err.max(initial=0.0)))
            denom = np.maximum(np.maximum(np.abs(xa), np.abs(ya)), 1e-30)
            max_rel = max(max_rel, float((err / denom).max(initial=0.0)))
            max_ulp = max(max_ulp, max_ulp_diff(xh, yh))
        out[name] = {"max_abs_err": max_abs, "max_rel_err": max_rel,
                     "max_ulp": max_ulp}
    return out


def _state_params(state):
    from serverless_learn_tpu_torch.bridge import nest

    return nest({n: p.detach() for n, p in state.model.named_parameters()})


class ParityHarness:
    """Run a reference and a candidate step function side by side on the
    same batches and report max-ulp / rel-err per parameter subtree per
    step. Both step functions take (state, batch) and return (state,
    metrics); ``params_of`` gives the compared tree of a state (by default
    the port's ``TrainState`` model parameters under their flax paths)."""

    def __init__(self, ref_step: Callable, cand_step: Callable,
                 ref_state, cand_state,
                 params_of: Callable = _state_params,
                 depth: int = DEFAULT_DEPTH,
                 cand_batch: Optional[Callable] = None):
        self.ref_step = ref_step
        self.cand_step = cand_step
        self.ref_state = ref_state
        self.cand_state = cand_state
        self.params_of = params_of
        self.depth = depth
        self.cand_batch = cand_batch or (lambda b: b)
        self.steps: List[dict] = []

    def __enter__(self) -> "ParityHarness":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def step(self, batch) -> dict:
        self.ref_state, _ = self.ref_step(self.ref_state, batch)
        self.cand_state, _ = self.cand_step(self.cand_state,
                                            self.cand_batch(batch))
        cmp = compare_trees(self.params_of(self.ref_state),
                            self.params_of(self.cand_state), self.depth)
        rec = {"step": len(self.steps) + 1, "subtrees": cmp}
        self.steps.append(rec)
        return rec

    def report(self, rtol: float = 1e-5, atol: float = 1e-6) -> dict:
        """Worst subtree errors over all driven steps and the first step any
        subtree exceeded rtol and atol."""
        worst: Dict[str, dict] = {}
        first_bad = None
        for rec in self.steps:
            for name, c in rec["subtrees"].items():
                if "error" in c:
                    continue
                w = worst.setdefault(name, {"max_abs_err": 0.0,
                                            "max_rel_err": 0.0,
                                            "max_ulp": 0})
                for k in w:
                    w[k] = max(w[k], c[k])
                if (first_bad is None and c["max_abs_err"] > atol
                        and c["max_rel_err"] > rtol):
                    first_bad = {"step": rec["step"], "subtree": name, **c}
        return {"steps": len(self.steps), "subtrees": worst,
                "within_tolerance": first_bad is None,
                "first_exceeded": first_bad}


# -- loss-health detectors ----------------------------------------------------


class LossHealth:
    """EWMA spike / plateau / explosion detection over per-step (loss,
    grad_norm) pairs; the health engine owns one and turns findings into
    alerts.

    * **loss_spike**: modified z of the new loss against the EWMA baseline
      above ``spike_z`` is a warning, above ``2 x spike_z`` critical;
    * **loss_plateau**: the best loss not improved by ``plateau_min_rel`` in
      ``plateau_window`` steps (after a full window) is a warning;
    * **grad_explosion**: grad-norm z above ``explode_z`` is critical;
    * a non-finite loss or grad norm is a critical ``nonfinite``."""

    def __init__(self, spike_z: float = 6.0, plateau_window: int = 50,
                 plateau_min_rel: float = 1e-3, explode_z: float = 8.0,
                 min_samples: int = 12):
        self.spike_z = spike_z
        self.explode_z = explode_z
        self.plateau_window = max(2, int(plateau_window))
        self.plateau_min_rel = plateau_min_rel
        self._loss = EwmaMad(min_samples=min_samples)
        self._grad = EwmaMad(min_samples=min_samples)
        self._best_loss: Optional[float] = None
        self._best_step: Optional[int] = None
        self._n = 0

    def update(self, step: int, loss: Optional[float],
               grad_norm: Optional[float] = None) -> Dict[str, Optional[dict]]:
        """One step's verdicts: {"loss_spike", "loss_plateau",
        "grad_explosion", "nonfinite"}, None where that detector is calm."""
        out: Dict[str, Optional[dict]] = {
            "loss_spike": None, "loss_plateau": None,
            "grad_explosion": None, "nonfinite": None}
        self._n += 1
        if loss is not None and not np.isfinite(loss):
            out["nonfinite"] = {"severity": "critical", "value": float("nan"),
                                "threshold": 0.0,
                                "message": f"loss is non-finite at step "
                                           f"{step}"}
            return out  # a NaN loss must not poison the baselines
        if loss is not None:
            z = self._loss.update(float(loss))
            if z is not None and z > self.spike_z:
                sev = "critical" if z > 2 * self.spike_z else "warning"
                out["loss_spike"] = {
                    "severity": sev, "value": float(loss),
                    "threshold": self.spike_z,
                    "message": f"loss {loss:.6g} spiked at step {step} "
                               f"(z={z:.1f}, ewma="
                               f"{self._loss.ewma:.6g})"}
            improved = (self._best_loss is None
                        or loss < self._best_loss
                        * (1 - self.plateau_min_rel))
            if improved:
                self._best_loss = float(loss)
                self._best_step = step
            elif (self._best_step is not None
                  and self._n > self.plateau_window
                  and step - self._best_step >= self.plateau_window):
                out["loss_plateau"] = {
                    "severity": "warning", "value": float(loss),
                    "threshold": float(self.plateau_window),
                    "message": f"loss has not improved by "
                               f"{self.plateau_min_rel:g} rel in "
                               f"{step - self._best_step} steps "
                               f"(best {self._best_loss:.6g} at step "
                               f"{self._best_step})"}
        if grad_norm is not None:
            if not np.isfinite(grad_norm):
                out["nonfinite"] = {
                    "severity": "critical", "value": float("nan"),
                    "threshold": 0.0,
                    "message": f"grad norm is non-finite at step {step}"}
                return out
            gz = self._grad.update(float(grad_norm))
            if gz is not None and gz > self.explode_z:
                out["grad_explosion"] = {
                    "severity": "critical", "value": float(grad_norm),
                    "threshold": self.explode_z,
                    "message": f"grad norm {grad_norm:.6g} exploded at "
                               f"step {step} (z={gz:.1f}, ewma="
                               f"{self._grad.ewma:.6g})"}
        return out


# -- per-step record ring + last report (the /numerics read side) -------------

# The auditor publishes here (and to the event log); the health engine's
# numerics tick and the /numerics endpoint read it without a handle through
# the training stack.
_steps_lock = threading.Lock()
_steps: deque = deque(maxlen=512)
_last_report: Optional[dict] = None


def note_step(record: dict):
    """Publish one per-step numerics record ({"step", "loss", "grad_norm",
    "nonfinite", ...}); bounded, thread-safe."""
    with _steps_lock:
        _steps.append(dict(record))


def recent_steps(n: int = 64) -> List[dict]:
    with _steps_lock:
        return list(_steps)[-n:]


def clear_steps():
    global _last_report
    with _steps_lock:
        _steps.clear()
        _last_report = None


def set_last_report(report: dict):
    """The auditor's newest host-fetched summary (floats only: a scrape
    never reaches a tensor)."""
    global _last_report
    with _steps_lock:
        _last_report = dict(report)


def endpoint_payload() -> dict:
    """The ``/numerics`` body: the newest summary and the recent ring."""
    with _steps_lock:
        report = dict(_last_report) if _last_report else None
        recent = list(_steps)[-16:]
    return {"enabled": report is not None, "last": report,
            "recent_steps": recent}


# -- self-check ---------------------------------------------------------------


def self_check() -> dict:
    """The ``numerics --self-check`` smoke: the statistics are exact on
    fabricated tensors, a seeded NaN is named, fingerprint bisection finds a
    seeded divergence, the loss-spike detector fires. Never raises."""
    report: dict = {"ok": False, "checks": []}

    def check(name: str, ok: bool, detail: str = ""):
        report["checks"].append({"check": name, "ok": bool(ok),
                                 **({"detail": detail} if detail else {})})
        return ok

    try:
        rng = np.random.default_rng(0)
        tree = {"dense_0": {"kernel": rng.normal(size=(8, 4)).astype(
            np.float32), "bias": np.zeros((4,), np.float32)},
            "head": {"kernel": rng.normal(size=(4, 2)).astype(np.float32)}}
        stats = tree_stats(tree)
        want = float(np.sqrt((np.asarray(tree["dense_0"]["kernel"]) ** 2)
                             .sum()))
        got = float(stats["dense_0"]["l2"])
        check("stats_exact", abs(got - want) <= 1e-5 * max(want, 1.0),
              f"l2 got={got:.6g} want={want:.6g}")
        gn = float(global_norm(tree))
        want_gn = float(np.sqrt(sum(
            (np.asarray(l) ** 2).sum()
            for _, l in tree_flatten_with_path(tree))))
        check("global_norm_exact", abs(gn - want_gn) <= 1e-5 * want_gn,
              f"got={gn:.6g} want={want_gn:.6g}")

        bad = {k: {kk: np.array(vv) for kk, vv in v.items()}
               for k, v in tree.items()}
        bad["head"]["kernel"][1, 1] = np.nan
        hit = first_nonfinite(bad)
        check("nan_named", hit is not None
              and hit["subtree"] == "head" and hit["nan"] == 1,
              f"hit={hit}")

        fp = fingerprint_record(tree)
        fa = [{"event": "numerics_fingerprint", "step": s, "fp": fp}
              for s in range(6)]
        fb = [dict(r, fp={k: dict(v) for k, v in r["fp"].items()})
              for r in fa]
        for r in fb:
            if r["step"] >= 3:
                r["fp"]["head"] = dict(r["fp"]["head"],
                                       sum=r["fp"]["head"]["sum"] + 1.0)
        d = diff_fingerprint_logs(fa, fb)
        check("bisect_finds_seeded_divergence",
              d["diverged"] and d["first_divergent_step"] == 3
              and d["subtree"] == "head",
              f"diff={d}")

        lh = LossHealth(spike_z=4.0, min_samples=4)
        for i in range(12):
            v = lh.update(i, 2.0 - 0.01 * i)
            assert not any(v.values()), v
        fired = lh.update(12, 50.0)["loss_spike"]
        check("loss_spike_fires", fired is not None
              and fired["severity"] == "critical", f"finding={fired}")

        ident = compare_trees(tree, tree)
        check("parity_identical_zero_ulp",
              all(c["max_ulp"] == 0 for c in ident.values()),
              f"{ident}")
        report["ok"] = all(c["ok"] for c in report["checks"])
    except Exception as e:
        check("exception", False, f"{type(e).__name__}: {e}")
    return report
