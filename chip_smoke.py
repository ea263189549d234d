#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA H100 and hold its kernels to
their plain versions.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught on the way out):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit;
2. each kernel against its plain PyTorch version on the card, at blocks
   16, 32, 64 and 128 with ragged edges, a ``pad_schedule``-padded schedule
   and an empty one;
3. the main path: all nine Table 6 layers at their published M, N, K and
   sparsities, block-structured at block 32, through
   ``flexagon_plan(..., backend="cuda")`` with each of the six dataflows
   pinned and the dense escape off, each plan applied twice, then the
   ``auto`` choice at the default escape threshold; every result against an
   fp64 dense product;
4. ``CompressedFFN`` at the qwen2-1.5b width (d_model 1536, d_ff 8960),
   block 128 at block sparsity 0.5 — a chosen stand-in, since no config of
   the repo prunes its FFN — for 4 tokens (the 4-slot decode of
   ``examples/serve_batch.py``) and 128 (a prefill), against the masked
   dense FFN in fp64;
5. both kernels' launch counts over phases 3-4 must be > 0;
6. each distinct kernel launch of the main path, replayed as
   ``CudaBackend.kernel_call`` makes it and held bit for bit to the main
   path's own result: checked against its plain version on the same
   inputs, and timed beside the plain version, one ``torch.matmul`` on
   the densified inputs, and the least time the card could take.

Its last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  With no CUDA device it exits 2 before
printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

#: NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

TOL = 1e-4          # rtol = atol for kernel vs plain, both fp32
REL_TOL = 1e-4      # max|out - ref| / max|ref| against the fp64 product
SEED = 0
REPS = 20


def log(*parts) -> None:
    print(*parts, flush=True)


# -- phase 1 -----------------------------------------------------------------


def build_kernels():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = {name: build.build(name)[1] for name in build.SOURCES}
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(logs)}; nvcc {build.FLAGS[1]})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    return card


# -- phase 2 -----------------------------------------------------------------


def _block_sparse(rng, shape, block, density):
    """Dense values with exactly round(density x blocks) blocks present
    (at least one where density > 0), placed uniformly at random."""
    import numpy as np

    gm, gk = -(-shape[0] // block[0]), -(-shape[1] // block[1])
    keep = min(gm * gk, max(int(density > 0), round(density * gm * gk)))
    mask = np.zeros(gm * gk, bool)
    mask[rng.choice(gm * gk, size=keep, replace=False)] = True
    full = np.kron(mask.reshape(gm, gk), np.ones(block, bool))
    x = rng.standard_normal(shape).astype(np.float32)
    return np.where(full[: shape[0], : shape[1]], x, np.float32(0))


def _operands(rng, m, k, n, block, da, db, device):
    import torch

    a = _block_sparse(rng, (m, k), block[:2], da)
    b = _block_sparse(rng, (k, n), block[1:], db)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def kernel_sweep(device, blocks=(16, 32, 64, 128)):
    """Each kernel vs its plain version at several blocks, padded, empty."""
    import numpy as np
    import torch

    from repro_torch.core import dataflows as df
    from repro_torch.core.formats import dense_to_bcsc, dense_to_bcsr
    from repro_torch.kernels import stream as ks

    rng = np.random.default_rng(SEED)
    worst = {"stream_spmm": 0.0, "stream_panel_spmm": 0.0}
    for blk in blocks:
        m, k, n = 3 * blk + 5, 4 * blk + 3, 5 * blk + 7      # ragged edges
        a, b = _operands(rng, m, k, n, (blk, blk, blk), 0.5, 0.5, device)
        bs = (blk, blk)
        a_r, a_c = dense_to_bcsr(a, bs), dense_to_bcsc(a, bs)
        b_r, b_c = dense_to_bcsr(b, bs), dense_to_bcsc(b, bs)
        mb, nb = a_r.grid[0], b_r.grid[1]
        cases = [
            ("stream_spmm", "ip", a_r, b_c,
             ks.schedule_from_ip(df.build_ip_plan(a_r, b_c))),
            ("stream_spmm", "op", a_c, b_r,
             ks.schedule_from_stream(df.build_op_plan(a_c, b_r),
                                     by_dest=True)),
            ("stream_panel_spmm", "gust", a_r, b_r,
             ks.schedule_from_stream(df.build_gust_plan(a_r, b_r),
                                     by_dest=False)),
        ]
        for name, label, x, y, sched in cases:
            padded = ks.pad_schedule(sched, sched.n_work + 5,
                                     sched.n_runs + 3, mb)
            empty = ks._empty_schedule(sched.kind)
            for tag, s in (("plain", sched), ("padded", padded),
                           ("empty", empty)):
                kernel = getattr(ks, name)
                plain = getattr(ks, name + "_plain")
                ds = ks.device_schedule(s, device)
                kw = dict(out_grid=(mb, nb), out_shape=(m, n))
                got = kernel(x.data, y.data, ds, **kw)
                want = plain(x.data, y.data, ds, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max()) if got.numel() else 0.
                rel = err / max(float(want.abs().max()), 1e-30) \
                    if got.numel() else 0.
                ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
                if tag != "empty":
                    ref = (x.todense().double() @ y.todense().double())
                    ok = ok and torch.allclose(got.double(), ref, rtol=TOL,
                                               atol=TOL)
                log(f"sweep {name:17s} block={blk:3d} {label:4s} {tag:6s} "
                    f"W={s.n_work:5d} max|kernel-plain|={err:.3e} "
                    f"(/max|plain| {rel:.1e}) allclose rtol=atol={TOL:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version at block {blk} ({tag})")
                worst[name] = max(worst[name], err)
    return worst


# -- phases 3 and 4 ----------------------------------------------------------


def _rel_err(out, ref) -> float:
    return float((out.double() - ref).abs().max() / ref.abs().max()
                 .clamp_min(1e-30))


def table6(device, calls):
    """Every Table 6 layer, six pinned dataflows x2 applies, then auto."""
    import numpy as np

    from repro_torch import flexagon_plan, get_backend
    from repro_torch.core.dataflows import DATAFLOWS
    from repro_torch.core.workloads import PAPER_LAYERS

    cuda = get_backend("cuda")
    default_threshold = cuda.dense_threshold
    rng = np.random.default_rng(SEED + 1)
    bs = (32, 32, 32)
    for name, L in PAPER_LAYERS.items():
        a, b = _operands(rng, L.m, L.k, L.n, bs, L.density_a, L.density_b,
                         device)
        ref = a.double() @ b.double()
        worst = 0.0
        cuda.dense_threshold = 2.0            # escape off: kernels only
        try:
            for d in DATAFLOWS:
                plan = flexagon_plan(a, b, dataflow=d, block_shape=bs,
                                     backend="cuda")
                for _ in range(2):
                    out = plan.apply(a, b)
                    worst = max(worst, _rel_err(out, ref))
                calls.append((f"{name}", plan, a, b, out))
        finally:
            cuda.dense_threshold = default_threshold
        auto = flexagon_plan(a, b, block_shape=bs, backend="cuda")
        worst = max(worst, _rel_err(auto.apply(a, b), ref))
        log(f"table6 {name:6s} M={L.m} N={L.n} K={L.k} spA={L.sp_a}% "
            f"spB={L.sp_b}%: six dataflows x2 applies, max rel err "
            f"{worst:.2e} (tol {REL_TOL:g}); auto -> {auto.dataflow} "
            f"dense_escape={'dense' in auto.aux}")
        if worst > REL_TOL:
            raise SystemExit(f"table6 {name}: error {worst:.2e} > {REL_TOL}")


def qwen2_ffn(device, d=1536, f=8960, block=128):
    """CompressedFFN at qwen2-1.5b width, decode (4) and prefill (128).

    Returns (planned entry, input, output) of each token count."""
    import numpy as np
    import torch

    from repro_torch import compress_ffn, get_backend, sparse_ffn_apply
    from repro_torch.convert import ffn_params_from_jax
    from repro_torch.models.ffn import _masked_weight

    sparsity = 0.5
    rng = np.random.default_rng(SEED + 2)
    scale = 1.0 / np.sqrt(d)
    tree = {
        "w_gate": {"w": rng.standard_normal((d, f), np.float32) * scale},
        "w_up": {"w": rng.standard_normal((d, f), np.float32) * scale},
        "w_down": {"w": rng.standard_normal((f, d), np.float32) * scale},
        "block_mask": (rng.random((d // block, f // block)) >= sparsity
                       ).astype(np.float32),
    }
    params = ffn_params_from_jax(tree, device=device)
    mask = params["block_mask"]
    wg = _masked_weight(params["w_gate"]["w"], mask).double()
    wu = _masked_weight(params["w_up"]["w"], mask).double()
    wd = _masked_weight(params["w_down"]["w"], mask.T).double()

    cuda = get_backend("cuda")
    default_threshold = cuda.dense_threshold
    cuda.dense_threshold = 2.0    # escape off: 0.5 occupancy would take it
    try:
        comp = compress_ffn(params, tokens=4, block=block, backend="cuda",
                            device=device)
        runs = []
        for batch, seq in ((4, 1), (1, 128)):
            x = torch.as_tensor(rng.standard_normal((batch, seq, d),
                                                    np.float32),
                                device=device)
            out = sparse_ffn_apply(comp, x)
            out = sparse_ffn_apply(comp, x)
            x2 = x.reshape(-1, d).double()
            ref = ((torch.nn.functional.silu(x2 @ wg) * (x2 @ wu)) @ wd
                   ).reshape(batch, seq, d)
            err = _rel_err(out, ref)
            entry = comp.specialize(batch * seq)
            log(f"ffn qwen2-1.5b tokens={batch * seq:4d} "
                f"plan_in={entry.plan_in.dataflow} "
                f"plan_out={entry.plan_out.dataflow} rel err {err:.2e} "
                f"(tol {REL_TOL:g})")
            if err > REL_TOL:
                raise SystemExit(f"ffn tokens={batch * seq}: error {err:.2e}")
            runs.append((entry, x, out))
    finally:
        cuda.dense_threshold = default_threshold
    # tokens=4 is built at construction and hit by both applies and the
    # specialize above (3); tokens=128 is built by its first apply and hit
    # by the second and by specialize (2)
    log(f"ffn plan_builds={comp.plan_builds} plan_hits={comp.plan_hits} "
        f"(block sparsity {sparsity} at block {block}: chosen stand-in)")
    if comp.plan_builds != 2 or comp.plan_hits != 5:
        raise SystemExit("ffn plan cache did not plan once per token shape")
    return runs


def replay_ffn(runs, calls):
    """The three applies ``sparse_ffn_apply`` makes, replayed after the
    launch counts are read: they must give its result bit for bit, so the
    calls phase 6 times are its own."""
    import torch

    for entry, x, out in runs:
        tokens = out.shape[0] * out.shape[1]
        x2f = x.reshape(tokens, -1)
        g = entry.plan_in.apply(x2f, entry.w_gate)
        h = (torch.nn.functional.silu(g)
             * entry.plan_in.apply(x2f, entry.w_up))
        y = entry.plan_out.apply(h, entry.w_down)
        if not torch.equal(y.reshape(out.shape), out):
            raise SystemExit(f"ffn tokens={tokens}: the replayed applies "
                             "differ from sparse_ffn_apply")
        calls.append((f"ffn{tokens}_in", entry.plan_in, x2f, entry.w_gate,
                      g))
        calls.append((f"ffn{tokens}_out", entry.plan_out, h, entry.w_down,
                      y))


# -- phase 6 -----------------------------------------------------------------


def _block_coords(op):
    """(block row, block column) of each stored block of ``op``."""
    import numpy as np

    from repro_torch.core.formats import BlockCSR

    major = np.repeat(np.arange(op.indptr.size - 1), np.diff(op.indptr))
    minor = np.asarray(op.indices)
    return (major, minor) if isinstance(op, BlockCSR) else (minor, major)


def _bound_ms(call):
    """Least time the card could take for one launch's work: (bytes moved,
    operations done), each as ms at the data sheet's rates.

    Both count the valid extent of every block (rows past M, columns past
    N and depth past K are padding the function does not need): each input
    block the work list reads, once; the work list and segment table the
    kernel is passed, once; C written once; 2 operations per multiply-add
    of each work entry that lands in C.
    """
    import numpy as np

    x, y, ds = call.x, call.y, call.schedule
    (m, k), n = x.shape, y.shape[1]
    bm, bk, bn = x.data.shape[1], x.data.shape[2], y.data.shape[2]

    def host(t):
        return t.cpu().numpy().astype(np.int64)

    def valid(idx, blk, total):
        return np.clip(total - idx * blk, 0, blk)

    a_slot, b_slot = host(ds.a_slot), host(ds.b_slot)
    seg_start, seg_ci = host(ds.seg_start), host(ds.seg_ci)
    seg_of = np.repeat(np.arange(seg_ci.size), np.diff(seg_start))
    ci = seg_ci[seg_of]
    panel = call.kernel.__name__ == "stream_panel_spmm"
    cj = host(ds.cj) if panel else host(ds.seg_cj)[seg_of]
    keep = (ci >= 0) & (ci < x.grid[0])             # pad runs write nothing
    a_row, a_col = _block_coords(x)
    b_row, b_col = _block_coords(y)
    ops = 2.0 * np.sum(valid(ci[keep], bm, m)
                       * valid(a_col[a_slot[keep]], bk, k)
                       * valid(cj[keep], bn, n))
    a_used = np.unique(a_slot[keep])
    b_used = np.unique(b_slot[keep])
    values = (np.sum(valid(a_row[a_used], bm, m) * valid(a_col[a_used], bk, k))
              + np.sum(valid(b_row[b_used], bk, k)
                       * valid(b_col[b_used], bn, n)))
    index = (ds.a_slot, ds.b_slot, ds.seg_start, ds.seg_ci,
             ds.cj if panel else ds.seg_cj)
    nbytes = 4 * (int(values) + sum(t.numel() for t in index) + m * n)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(ops) / FP32_FLOP_PER_S * 1e3)


def _device_ms(fn, reps=REPS):
    """Device time per call: the kernels and memsets ``fn`` launches, as
    the profiler records them; CUDA events around ``reps`` calls where it
    records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(reps):
            with record_function("timed"):
                fn()
        torch.cuda.synchronize()
    # device-side events only, and not the "timed" annotation itself,
    # whose span on the device timeline includes the host's gaps
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name != "timed")
    if us > 0:
        return us / 1e3 / reps, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


def time_main_path(calls, worst):
    """Replay each distinct kernel launch of the main path, as the cuda
    backend makes it, and time it beside its plain version, one
    ``torch.matmul`` on the densified inputs, and its bound."""
    import torch

    from repro_torch import get_backend
    from repro_torch.kernels import stream as ks

    cuda = get_backend("cuda")
    totals = {}
    seen = set()
    for label, plan, a, b, applied in calls:
        if "dense" in plan.aux:
            raise SystemExit(f"{label}/{plan.dataflow} took the dense escape")
        call = cuda.kernel_call(plan, plan.pack_a(a).unwrap(),
                                plan.pack_b(b).unwrap())
        if id(call.schedule) in seen:
            continue
        seen.add(id(call.schedule))
        name = call.kernel.__name__
        plain = getattr(ks, name + "_plain")
        got = call.run()
        want = call.run(plain)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise SystemExit(f"{name} at {label}/{plan.dataflow}: kernel vs "
                             f"plain max|d|={err:.3e} > tol {TOL}")
        same = applied.T if call.transposed else applied
        if not torch.equal(got, same.contiguous()):
            raise SystemExit(f"{label}/{plan.dataflow}: replayed kernel "
                             "call differs from the main path's")
        worst[name] = max(worst[name], err)
        xd, yd = call.x.todense().float(), call.y.todense().float()
        ms, how = _device_ms(call.run)
        plain_ms, _ = _device_ms(lambda: call.run(plain))
        lib_ms, _ = _device_ms(lambda: torch.matmul(xd, yd))
        t_bytes, t_ops = _bound_ms(call)
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        blk = "x".join(map(str, (*call.x.data.shape[1:],
                                 call.y.data.shape[2])))
        log(f"time {name:17s} {label:9s} {plan.dataflow:6s} "
            f"W={call.schedule.n_work:6d} block={blk} ms={ms:.4f} ({how}) "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f} ({by}; bytes {t_bytes:.5f}, "
            f"operations {t_ops:.5f}) max|kernel-plain|={err:.2e}")
        t = totals.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "bytes": 0.0, "operations": 0.0,
                                     "calls": 0})
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] += lib_ms
        t["bound_ms"] += bound
        t[by] += bound          # how much of the summed bound each side sets
        t["calls"] += 1
    return totals


SOURCES = {
    "stream_spmm": ("src/repro_torch/csrc/stream_spmm.cu",
                    "src/repro/kernels/stream.py:330"),
    "stream_panel_spmm": ("src/repro_torch/csrc/stream_spmm.cu",
                          "src/repro/kernels/stream.py:415"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)
    from repro_torch.kernels import stream as ks

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    card = build_kernels()
    worst = kernel_sweep(device)

    calls = []
    ks.stream_spmm.launches = 0
    ks.stream_panel_spmm.launches = 0
    table6(device, calls)
    ffn_runs = qwen2_ffn(device)
    torch.cuda.synchronize()
    launches = {"stream_spmm": ks.stream_spmm.launches,
                "stream_panel_spmm": ks.stream_panel_spmm.launches}
    log(f"main-path kernel launches: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")

    replay_ffn(ffn_runs, calls)
    totals = time_main_path(calls, worst)
    kernels = []
    for name, t in totals.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes"] >= t["operations"]
            else "operations",
            "library_ms": t["library_ms"], "calls_timed": t["calls"],
        })
    log(f"times above sum over the {sum(t['calls'] for t in totals.values())}"
        f" distinct kernel calls of one main-path pass, on {card}; "
        f"bound = sum over calls of max(bytes at {HBM_BYTES_PER_S:g} B/s, "
        f"fp32 operations at {FP32_FLOP_PER_S:g}/s), bound_by = the side "
        "that sets most of it; library = torch.matmul on the densified "
        "inputs")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
