#!/usr/bin/env python3
"""Chip check of graphblast_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card
    python3 chip_smoke.py --tc-classes   # only the build and phase 16's
                                         # class split of T1

Phases, each of which fails the run on error (each prints its seconds):
  1. device and build: prints the card's name and power limit, builds every
     CUDA kernel from csrc/ with nvcc (one nvcc per source, all at once);
  2. K1 vs plain: at RMAT scale 18 (edge factor 16, seed 42) runs the
     bitmap pull K1 and its plain PyTorch version on three frontiers (the top
     hub, the hub's level-2 frontier, a seeded 20% frontier); counts must be
     equal (tolerance 0: both are int32 counts), to a second launch, to
     torch.sparse CSR · frontier and, one warp a row (the first design's
     schedule in the same kernel), to the plain version. Prints the plan's
     row schedule (the CSC's, shared); times the kernel, one warp a row, the
     plain version and torch.sparse (a yardstick only; the package never
     calls it) with CUDA events, and computes the kernel's bound. Beside
     each frontier runs K1's masked entry under BFS's visited mask at that
     frontier's iteration, taken from the hub's golden levels (levels 1 .. it
     for the hub's level `it`; levels 1 .. 2 for the 20% frontier),
     complemented: it must equal (count > 0) & the mask's pass bitwise, its
     plain version and a second launch, and is timed beside the count and
     its plain version with its least bytes (the open rows' ids up to their
     first frontier id, their row pointers, three n/8 B bitmaps);
  3. BFS main path: pull-only BFS through graphblast_tpu_torch.algorithms.bfs
     from the 8 highest-degree sources; levels must equal the NumPy golden,
     K1 must have launched once per BFS iteration and BFS's plan must read
     the Matrix's cached CSC schedule (it built none). Prints ms/run (median
     over reps, synchronized) and GTEPS over reached edges;
  4. value pull (K2's call site) at RMAT scale 18: the CSR plan with the
     stored values and a seeded standard-normal x; the kernel must agree with
     its plain version within 1e-5 * max|y_plain| and be bitwise equal to a
     second launch. Prints the row schedule (rows per bin, long rows,
     chunks, blocks) and its build time on the card; times the kernel, the
     plain version, torch.mv on the same CSR (a yardstick only) and the
     first design's schedule, one warp a row (the same kernel with every
     row in the medium bin), computes the bound, times the longest row
     alone (a one-row plan, cut into chunks), each bin's blocks alone, and
     the medium bin's rows alone by length (33-256, 257-1024, 1025-4096,
     4097-T edges);
  5. PageRank main path: graphblast_tpu_torch.algorithms.pr (fused, alpha
     0.85, eps 1e-8) at RMAT scale 18 against the port's NumPy golden at its
     fixed point (eps 1e-14); requires sum |p - p_gold| <= 1e-4 and a relative
     error <= 1e-3 on the 100 top-ranked vertices, and one value-pull launch
     per iteration, over the Matrix's cached CSC schedule (pr() builds none).
     Prints the iterations, ms per pr() call, the plan build and the loop,
     ms per iteration, pr_iters_per_s and the kernel's share;
  6. K4, the monoid pull, at RMAT scale 18 for its four semirings:
     MinimumPlus over the CSC with seeded weights in [0.5, 2) and x 40%
     FLT_MAX, the rest uniform in [0, 5) (SSSP's call site);
     MinimumSelectSecond over the unit-valued CSR with x the float32 ids
     (CC's); MinimumMultiplies and MaximumMultiplies over the weighted CSC
     with a uniform x. Each must be torch.equal to its plain version
     (tolerance 0), to a second launch and, one warp a row (the first
     design's schedule in the same kernel), to the plain version, finite,
     of shape (n_out,). Prints the CSC's and the CSR's row schedules (the
     Matrix's cached ones); times the kernel, one warp a row and the plain
     version with CUDA events, computes the bound, and times the longest
     row alone. Then K4's masked entry (SSSP's pull) over the weighted
     CSC, at each step of a pull-only relaxation from its longest row and
     at the MinimumPlus x under the last step's distances v: torch.equal
     to its plain version with the bound and to a second launch, equal to
     the unmasked K4 after SSSP's filter where(y < v, y, FLT_MAX), one
     launch counted in spmv_monoid.launches and .masked_launches; timed
     beside the unmasked K4 with its least bytes (the open rows' ids and
     pointers, x and the weight at their frontier columns, the bound, y
     and the frontier's bitmap);
  7. SSSP main path: graphblast_tpu_torch.algorithms.sssp pull-only from
     the 8 highest-degree sources; distances must equal the port's NumPy
     golden exactly, K4 must have launched once per iteration, each launch
     through the masked entry, no other kernel at all, and SSSP's plan
     must read the cached CSC schedule.
     Prints ms/run (median and tail over 80 synchronized runs), the
     iterations, GTEPS over reached edges and K4's share;
  8. CC main path: graphblast_tpu_torch.algorithms.cc; labels must equal
     the port's golden and pass verify_cc, with one K4 launch per
     iteration, over a plan that reads the cached CSR schedule. Prints
     ms/run (median and tail over 40 runs), the iterations, the component
     count, cc_gteps and K4's share;
  9. K6, the gather, at RMAT scale 18 in four cases: a float32 table of n
     at the CSC's row ids (MIS's gather of x, m = nnz_pad), an int32 table
     of nnz_pad at the sorted row boundaries col_ptr - 1 (m = n + 1), the
     packed frontier words (8,192, the small-table class) at the row ids
     >> 5, and the first case over the misaligned slice of the row ids
     from 1 (the scalar path). Each must be torch.equal to its plain
     version, to a second launch and to torch.index_select. Times the
     kernel, the plain version and torch.index_select (a yardstick only)
     with CUDA events, and computes the bound; at the row boundaries it
     prints the [K6 launch] line: host us a call of the wrapper,
     torch.index_select, the first launch path's lines and each of their
     pieces over 10,000 back-to-back calls;
  10. K5, the or-pull prefix count (one launch with decoupled look-back,
     after a memset of its scratch), over the CSC's row ids with the hub's
     level-2 frontier and a seeded 20% frontier: torch.equal to its plain
     version and to a second launch; timed, with device times and its
     bound, and at each block size the kernel takes (tiles of 2,048,
     4,096 and 8,192 edges);
  11. S, the min/max row fold of the plan-less pull, at rmat18 over the
     Matrix's cached CSC and CSR schedules: MaximumMultiplies over the
     int32 CSC with MIS's first-round weights (and the masked pull against
     the old route), MinimumSelectSecond over the int32 CSR with the ids
     as x (plan-less CC's call site), MinimumPlus, MinimumMultiplies and
     MinimumNotEqualTo on int32 x of every sign, and all five on float32 x
     with ±inf; each torch.equal to its plain version, to a second launch
     and to the old route (the gather, then the segmented scan); timed
     beside the old route, torch.segment_reduce over the products (a
     yardstick only; on float32 where it refuses int32) and its bound;
  12. stepped BFS, which pulls with no plan: from the 8 hubs, levels equal
     to the NumPy golden, one K5 and one K6 launch (at the row boundaries)
     per iteration and no other kernel; ms/run as phase 3;
  13. MIS through graphblast_tpu_torch.algorithms.mis: verify_mis holds,
     one S launch a round (the max pull), one K6 launch at the column ids
     and one at the row boundaries (the or pull), and no other kernel;
     rounds, set size and ms/run (median and tail over 40 calls); a
     round's two pulls and S timed alone and a torch.profiler trace of one
     call (device busy time, idle share, costliest kernels);
  14. graph colouring through graphblast_tpu_torch.algorithms.gc: "is"
     (one S a round, no K6) and "jp" with max_colors above the colours of
     "is" (one S, one K6 at the column ids and one at the boundaries a
     round), each timed over 10 calls; "mis" checked once (the same three
     a round of each colour's MIS). verify_gc holds for each;
  15. CC without a plan (the route of n >= 2^24) on the rmat18 graph:
     labels equal to the golden and verify_cc, one S launch an iteration
     and no other kernel; ms/run (40 calls) beside phase 8's;
  16. triangle counting at rmat18 over T1, the masked-intersection count,
     over its intersection schedule (each edge on the bitmap or the search
     route): L = tril(A) (its build time), the first tc(L) (the lists'
     check and the schedule build, timed, and the build alone), then 10
     timed calls (ms/run, M edges/s as bench.py reckons them: A's nnz over
     a call), one T1 launch a call, no second schedule; the route split
     (edges and ids on each route, units, pieces) and the route counters
     of every launch equal to the schedule's; the count equal to T1's
     plain version on the card and to a second launch, printed beside the
     JAX bench's record on the same graph (82,996,539; a record, not a
     check); tc equal to the host golden tc_cpu at RMAT scale 16. T2, the
     semiring fold: mxm(L, L, mask L, transpose_inp1) with PlusMultiplies
     and MinimumPlus over L and over a seeded value-perturbed copy, and
     PlusMinus with that copy as B (⊗'s A-then-B order), one T2 launch
     each, MinimumPlus equal to the plain version, the sums within
     1e-5·max|c| of a float64 plain version, all bitwise equal to a second
     launch; MaximumMultiplies over negated values, equal to the plain
     version, with negative values where the walked list matched in full
     and the identity 0 elsewhere; trace_mxm_transpose equal to its plain
     version, on A and on the negated values (one T2 launch each). Times
     T1 and T2 (events, and events with torch.profiler on the same 100
     launches while nvidia-smi samples the SM clock and power), their
     plain versions, the walk's size and the schedule's cost model in L1
     wavefronts, and torch.sparse.mm of L by Lᵀ (cuSPARSE's SpGEMM, a
     yardstick only) where it can run: fewer than 2^31 products (at
     rmat18 it takes 3.3e9, so it is timed at rmat16 beside tc). Last, T1
     alone over sub-masks of L holding one walked-length class each
     (`--tc-classes` runs only this, on the package beside the script);
  17. TC past the shared-memory budget: a seeded random graph made on the
     card, n = 2^21 (its bitmap 256 KB), about 6 M edges: tc, the masked
     mxm (PlusMultiplies, MinimumPlus) and the trace (MinimumPlus) send
     every edge down the search route, one launch each, equal to their
     plain versions;
  18. push BFS: PUSHONLY BFS (BFS_TUNED's structure-only push over the
     CSR: the bitmap push P) at rmat18 from the 8 hubs: levels equal to
     the golden, P launched once an iteration and no other kernel; ms/run
     (median and tail) and GTEPS beside phase 3's pull; the stepped trace
     of the first hub (each iteration's frontier, degree total, push route
     and lanes, host reads counted by torch.cuda.set_sync_debug_mode and
     ms);
     one push iteration at the hub's level-2 frontier: the sort push
     split into the expansion, the sort, the fill and the compaction,
     each timed alone by CUDA events, beside mxv_dual whole and P alone
     (P and its plain version equal to mxv_dual; the `bitmap_push` entry,
     with its bound and the sort push's steps); and K6 at the sort push's
     largest gather (the adjacency ids at the expansion's edge ids)
     torch.equal to its plain version, to a second launch and to
     torch.index_select, timed beside both with its bound (the
     `gather_push` entry, its launches the push SSSP's);
  19. push SSSP: PUSHONLY SSSP at rmat18 from the 8 hubs: distances equal
     to the golden, K6 launched 6 times an iteration (the scatter push of
     one lane an edge: 2 row-pointer gathers, the lanes' edge bases, the
     adjacency and the two value gathers), or, in an iteration whose
     frontier passes `slice_lanes` and so is cut into slices, 2 and 6 a
     slice, and no K4; ms/run and GTEPS beside phase 7's pull;
  20. grid_matrix(512) (n = 262,144, diameter 1,022): BFS from vertex 0,
     PUSHONLY (one P an iteration) and PULLONLY (one K1 an iteration),
     levels equal to the golden in both; ms/run and ms an iteration;
  21. PUSHPULL BFS: the default bfs(A, s) (BFS_TUNED) at rmat18
     from the 8 hubs: levels equal to the golden; K1 once a pull iteration
     and P once a push iteration (the directions from a stepped replay of
     each source), no other kernel, and in the stepped mode K5 and K6
     once a pull iteration; at most 2 host reads an iteration
     (torch.cuda.set_sync_debug_mode); ms/run (median and tail) and GTEPS
     beside phases 3 and 18; the top hub's stepped trace (direction,
     frontier, degree total, push route and lanes, host reads, ms);
  22. PUSHPULL SSSP: the default sssp(A, s) (DEFAULT) the same way: K4 once
     a pull iteration, each through the masked entry, and K6 6 times a
     push iteration; ms/run beside
     phases 7 and 19;
  23. PUSHPULL BFS from vertex 0 on phase 20's grid: levels equal to the
     golden; push and pull iterations, switches and host reads an
     iteration; the launches they give; ms/run and ms an iteration beside
     phase 20's two directions;
  24. valued BFS at rmat18 (BFS_TUNED with structure_only off, so each
     push takes mxv_dual's workspace route, the sort push of
     ops/spmspv.py) from the top hub, PUSHONLY and PUSHPULL through
     bfs(A, s, desc): levels equal to the golden; 11 K6 a push iteration
     (2 degree gathers, 5 in the expansion, 2 value gathers, 1 fill, 1
     mask), K6 once at the column ids and once at the row boundaries a
     pull iteration (no plan), and no other kernel; each push's lanes
     from mxv_dual's counters, at least its degree total and a multiple of
     1,024 or edge_cap; ms/run;
  25. diameter over sources [0, 8) at rmat18: equal to the largest golden
     eccentricity and its first source; ms a source;
  26. the gbfs driver as a subprocess with run_bfs.sh's flags on
     rmat:18:16 (python -m graphblast_tpu_torch.examples.gbfs): exit 0 and
     BFS: CORRECT; its output printed back;
  27. cc() at n = 2^24 on the port's grid_matrix(4096) (67 M edges), which
     takes the plan-less route: labels all 0 and verify_cc, one S launch
     an iteration over the CSR's cached schedule and no K4; the graph's
     build time and ms/run;
  28. value pull in K3's regime: a seeded uniform random CSR built on the
     card, 2^24 rows and columns, 8 edges a row, so that x (64 MB) exceeds
     the 50 MB L2; the same checks and timings as phase 4;
  29. the operations surface at rmat18: mxv and vxm on a seeded dense u
     under LogicalOrAnd (structure only: one K5 and one K6 a call),
     MinimumPlus (one S) and PlusMultiplies (K6 at the column ids and at
     the row boundaries), each with a complemented mask, a Plus
     accumulator and w, and under MinimumPlus on a sparse u of 1,000
     seeded ids, which pushes (10 K6); each equal to a scipy or NumPy
     golden (exact for min and or, 1e-5·max|y| for plus) and to the same
     call on a CPU copy (the plain kernels), its launches and ms a call;
     then K5 and S timed at their mxv call sites, and the row reduce
     (reduce_matrix_to_vector) under Plus, Min and Max on seeded values,
     one K6 a call, beside scatter_reduce;
  30. LGC at rmat18 from the top hub and from the first vertex of least
     nonzero degree (α 0.15, ε 1e-6): within rtol 1e-3 / atol 1e-7 of
     lgc_cpu, mass past the source, K6 once an iteration at
     the column ids and at the row boundaries (once more for the
     degrees), iterations and ms/run; K6 timed at LGC's gather; then the
     glgc driver as a subprocess on rmat:18:16: exit 0 and LGC: CORRECT;
  31. the unmasked SpGEMM C = A·A (the ESC) under PlusMultiplies and
     MinimumPlus on grid_matrix(512) and RMAT scale 14 (19 chunks, the
     cross-chunk merge), with seeded symmetric integer weights in 1..8:
     C's structure equal to scipy's A·A, its sums within 1e-5 relative of
     scipy's, its mins equal to a golden from one scipy product, 10 K6 a
     chunk,
     chunks, host reads, ms a call and torch.sparse.mm beside it; K6
     timed at the ESC's gather of B's ids;
  32. mxm_dense of rmat18's A by a seeded 262,144 × 32 float32 B, under
     PlusMultiplies (within 1e-5·max|C| of scipy's product) and
     MinimumPlus (equal to a NumPy golden); ms beside torch.sparse.mm;
  33. the six other drivers (gpr, gcc, gmis, ggc, ggc_cusparse,
     gtc) as subprocesses on rmat:18:16 with their run_*.sh flags, all six
     started at once: each exits 0 with its timing row; gcc, gmis and the
     two colourings print their CORRECT line (gpr and gtc skip the golden,
     as their run_*.sh TEST=1 lines do);
  34. native ingest: rmat18's raw COO written as a pattern .mtx under a
     temporary directory and read undirected by io.mmio.read_mtx on the
     native path (graphblast_tpu_torch/native, built with g++) and with
     GRB_NATIVE=0: the arrays equal, rmat18's edge count; both times;
  35. the distributed layer at world size 1 over NCCL (parallel/): its
     partition of rmat18; bfs_dist pull and auto from the 8 hubs equal to
     the goldens, one K1 a pull iteration and 7 K6 a push iteration (the
     directions replayed from the golden levels); sssp_dist from the hubs
     and cc_dist equal to the goldens of phases 7 and 8, one S an
     iteration (and CC one K6); pr_dist within phase 5's bars, one value
     pull an iteration; lgc_dist from the hub within phase 30's bar of
     lgc_cpu; each timed beside its single-device call; K1, the value
     pull and S at their dist call sites against their plain versions,
     timed, with bounds and library calls; then examples/scaling.py at
     scale 18 on the card as a subprocess (one NCCL rank spawned by
     parallel.launch): exit 0, its header and the P = 1 row;
  36. the second half of the distributed layer at world size 1 over NCCL
     (a 1 x 1 mesh with axes ("r", "c") for the 2D layout):
     bfs_dist(mode="dual") from the 8 hubs equal to the goldens, its
     directions equal to a host replay of the JAX loop's rule (one K1 a
     pull iteration, 9 K6 a push and 2 an iteration for the frontier's
     state, at most two host reads an iteration); owner_buckets' live
     pairs at the hub's level-2 frontier equal to the accounting's;
     pr_dist comm="ring" and comm="2d" within phase 5's bars (one K6 at
     the ids and one at the boundaries a stage, one for the out-degrees);
     tc_dist of tril(A) equal
     to tc() and 82,996,539, one T1 launch a stage, and tc_prepare's time;
     mis_dist and gc_dist (seed 1) verified, and equal to mis and gc(is)
     handed the same weights; partition_cached built, saved and loaded
     with equal arrays; each timed beside its single-device call; K6 at
     the ring stage's gather and T1 at tc_dist's stage against their plain
     versions, with two more kernels entries (`gather_ring`,
     `masked_intersect_count_dist`);
  37. the RMAT 20 and 22 cache: the port's cache tool (python -m
     graphblast_tpu_torch.tools.gen_rmat_cache 20 22) generates and
     canonicalizes both graphs on the host into a temporary directory,
     with nothing else running; prints its lines (each graph's
     generation, canonicalize and write seconds, its peak host memory);
  38. bench.py's bfs22 and spmv22 stages: RMAT 22 (n = 4,194,304, nnz =
     128,304,760; its column ids ten times the L2) through rmat_matrix
     from the cache (generation refused), the cache load and the build
     timed apart; phase 2's K1 checks and timings there, pull-only BFS
     from the 4 top-degree hubs equal to the golden, one K1 launch an
     iteration (ms/run and GTEPS); phase 4's value-pull checks and
     timings with a seeded x, max |y - y64| / (|y64| + 1) < 1e-3 against
     a float64 golden (bench.py's spmv check), and 10 PULLONLY mxv_dual
     calls over the plan, one value-pull launch each;
  39. bench.py's mtx stage: RMAT 20's raw COO written by io.mmio.write_mtx
     as a pattern .mtx, read directed by the native read_mtx (MB/s),
     built on the card; pull-only BFS from its 4 top-degree sources equal
     to the golden, one K1 launch an iteration;
  40. bench.py's tc20 stage: RMAT 20 from the cache, L = tril(A), tc(L)
     equal to T1's plain version and a second launch, 10 timed calls with
     one T1 launch each; then T2's ordered folds (GreaterPlus,
     CustomLessPlus, CustomLessLess, NotEqualToPlus, MultipliesMultiplies
     on float32 and int32: the ⊕ the JAX join folds in its own order) in
     mxm(X, Y, mask L, transpose_inp1) at rmat18's L with seeded values of
     both signs and on a seeded 2,000-vertex graph with hub rows, each one
     ordered launch, bitwise equal to its plain version and a second
     launch; the GreaterPlus fold timed beside its plain version;
  41. prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Every check of results, launch counts and schedules raises. A
torch.profiler reading that cannot be trusted (no device time, or more
device time than wall time) prints "not measured" and its reason and
does not fail the run. Exits non-zero, printing no result, when CUDA is
unavailable or the package is missing.
"""
import contextlib
import json
import subprocess
import sys
import tempfile
import time
import types

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published memory rate
MAXF32 = 3.4028234663852886e38   # FLT_MAX, the Minimum monoid's identity
RMAT18_N, RMAT18_NNZ = 262_144, 7_610_284
PR_ALPHA, PR_EPS = 0.85, 1e-8
# torch.sparse.mm of L by Lᵀ (cuSPARSE's SpGEMM) is timed where it can run:
# fewer products than cuSPARSE counts in 32 bits, and about this many device
# bytes a product (its output and buffers) free
LIBRARY_BYTES_A_PRODUCT = 16


def _event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_profile(fn, reps: int):
    """(device µs by kernel name, wall ms, why not measured, launches
    recorded by kernel name) of `reps` synchronized calls of fn under
    torch.profiler: the kernels' own events only, not the host ops that
    launched them. The table is empty, and the reason says why, when the
    trace holds no device time or more device time than wall time (events
    counted twice): a flaw of the reading, not of the kernels, so it is
    printed and does not fail the run. The trace may hold fewer launches
    than were made (PERF.md, PR 9), so a time a launch divides by the
    launches recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table, counts = {}, {}
    # the kernels' own events; a host op's device time repeats theirs
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:     # older releases name it after CUDA
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            table[e.key] = table.get(e.key, 0.0) + us
            counts[e.key] = counts.get(e.key, 0) + e.count
    busy_ms = sum(table.values()) / 1e3
    if not table:
        return {}, wall_ms, "the trace holds no device time", {}
    if busy_ms > wall_ms:
        return {}, wall_ms, (f"device busy {busy_ms:.6f} ms in a wall time "
                             f"of {wall_ms:.6f} ms: the trace counts some "
                             "device time twice"), {}
    return table, wall_ms, None, counts


def _device_ms(fn, reps: int, names) -> str:
    """Device ms per call of fn spent in kernels whose names contain one of
    `names`, from a torch.profiler trace, over the calls the trace
    recorded (a call launches each such kernel at most once, so the most
    launches of any one of them), or "not measured" and why."""
    table, _, why, counts = _device_profile(fn, reps)
    if why:
        return f"not measured ({why})"
    us = sum(v for k, v in table.items() if any(n in k for n in names))
    calls = max((v for k, v in counts.items()
                 if any(n in k for n in names)), default=0)
    if not (us and calls):
        return "not measured (no kernel of that name in the trace)"
    text = f"{us / calls / 1e3:.6f} ms"
    return text if calls == reps else (
        f"{text} ({calls} of {reps} calls recorded)")


def _smi_samples(text: str, t0: float, t1: float):
    """(SM MHz, memory MHz, W) of the nvidia-smi samples (lines of
    timestamp, clocks.sm, clocks.mem, power.draw) taken between the epoch
    times t0 and t1."""
    import datetime

    out = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 4:
            continue
        try:
            ts = datetime.datetime.strptime(
                parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
            sample = tuple(float(p) for p in parts[1:])
        except ValueError:
            continue
        if t0 <= ts <= t1:
            out.append(sample)
    return out


def _window(fn, reps: int, names, warm_s: float = 1.0) -> dict:
    """Events and torch.profiler on the same `reps` back-to-back calls of
    fn, in one window, with nvidia-smi sampling the card's clocks and
    power every 20 ms through it: {"events_ms": per call by CUDA events
    around the loop, "device_ms": per launch the trace recorded of the
    kernels whose names contain one of `names` (None if it holds none;
    it may miss some), "launches": how many it recorded, "span_ms": from
    the first such kernel's start to the last one's end, per launch
    recorded, "kernel_ms": (min, max) of one launch, "smi": [(SM MHz,
    memory MHz, W)]}. fn runs synchronized for `warm_s` seconds first, so the sampler
    has started and the clocks have settled under this load."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,clocks.mem,"
         "power.draw", "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        until = time.perf_counter() + warm_s
        while time.perf_counter() < until:
            fn()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            t1 = time.time()
    finally:
        smi.terminate()
        try:
            text = smi.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            smi.kill()
            text = smi.communicate()[0]
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(n in e.name for n in names)]
    out = {"events_ms": start.elapsed_time(end) / reps, "device_ms": None,
           "span_ms": None, "kernel_ms": None, "reps": reps,
           "smi": _smi_samples(text, t0, t1)}
    if spans:
        lengths = [(r.end - r.start) / 1e3 for r in spans]
        out["device_ms"] = sum(lengths) / len(spans)
        out["span_ms"] = (max(r.end for r in spans)
                          - min(r.start for r in spans)) / 1e3 / len(spans)
        out["kernel_ms"] = (min(lengths), max(lengths))
        out["launches"] = len(spans)
    return out


def _window_text(w: dict) -> str:
    def rng(i):
        vals = [s[i] for s in w["smi"]]
        return f"{min(vals):.0f}-{max(vals):.0f}" if vals else "none"

    dev = ("not measured (no kernel of that name in the trace)"
           if w["device_ms"] is None else
           f"{w['device_ms']:.6f} ms a launch over the {w['launches']} of "
           f"{w['reps']} launches the trace recorded, span "
           f"{w['span_ms']:.6f} ms a launch, one launch "
           f"{w['kernel_ms'][0]:.6f}-{w['kernel_ms'][1]:.6f} ms")
    return (f"same window: events {w['events_ms']:.6f} ms a call, device "
            f"(torch.profiler) {dev}; {len(w['smi'])} nvidia-smi samples: "
            f"SM {rng(0)} MHz, memory {rng(1)} MHz, {rng(2)} W")


def _wrappers():
    from graphblast_tpu_torch.ops.kernels.bitmap_pull import spmv_bitmap_pull
    from graphblast_tpu_torch.ops.kernels.bitmap_push import (
        spmspv_push_bitmap)
    from graphblast_tpu_torch.ops.kernels.gather import gather_1d
    from graphblast_tpu_torch.ops.kernels.masked_intersect import (
        masked_intersect_count, masked_intersect_fold)
    from graphblast_tpu_torch.ops.kernels.minmax_pull import spmv_minmax_pull
    from graphblast_tpu_torch.ops.kernels.monoid_pull import spmv_monoid
    from graphblast_tpu_torch.ops.kernels.orpull import orpull_bit_csum
    from graphblast_tpu_torch.ops.kernels.value_pull import spmv_value_pull

    return {"bitmap_pull": spmv_bitmap_pull, "value_pull": spmv_value_pull,
            "monoid_pull": spmv_monoid, "gather": gather_1d,
            "orpull_csum": orpull_bit_csum, "minmax_pull": spmv_minmax_pull,
            "masked_intersect_count": masked_intersect_count,
            "masked_intersect_fold": masked_intersect_fold,
            "bitmap_push": spmspv_push_bitmap}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "routes"):     # T1's and T2's edges by route
            fn.routes = dict.fromkeys(fn.routes, 0)
    _wrappers()["gather"].sorted_launches = 0
    _wrappers()["masked_intersect_fold"].ordered_launches = 0
    _wrappers()["monoid_pull"].masked_launches = 0


def _read_counts() -> dict:
    """Launches by kernel since _reset_counts(), K6's by call-site class:
    gather_x at the column ids, gather_boundary at the ascending segment
    tails and row boundaries (`take(..., sorted=True)`); T2's ordered fold
    (the comparison and multiplies ⊕) apart from its schedule-walked one;
    K4's masked launches (SSSP's pulls) again apart, each also counted in
    monoid_pull."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    gather = counts.pop("gather")
    counts["gather_boundary"] = _wrappers()["gather"].sorted_launches
    counts["gather_x"] = gather - counts["gather_boundary"]
    counts["masked_intersect_fold_ordered"] = _wrappers()[
        "masked_intersect_fold"].ordered_launches
    counts["monoid_pull_masked"] = _wrappers()["monoid_pull"].masked_launches
    return counts


def _median_and_tail(times):
    """(median s, the tail as text): the highest percentile q that has ten
    samples beyond it, "p{q} {ms} ms". With 20 samples or fewer that
    percentile is the median or below, and the text says there is no
    tail."""
    import numpy as np

    median = float(np.median(times))
    if len(times) <= 20:
        return median, f"no tail ({len(times)} runs)"
    q = 100.0 * (1 - 10 / len(times))
    return median, f"p{q:g} {float(np.percentile(times, q)) * 1e3:.6f} ms"


def phase_device_and_build():
    from graphblast_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    reports = _build.build()
    for name, log in reports.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(reports) or 'all current'} in "
          f"{time.perf_counter() - t0:.2f} s")


def _timed_runs(fn, n: int):
    """(median s, tail text) of n synchronized calls of fn."""
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return _median_and_tail(times)


def _expect_launches(path: str, expected: dict, counts=None) -> dict:
    """`counts`, by default the launch counts since _reset_counts(); raises
    unless each kernel named in `expected` launched exactly that often and
    no other kernel launched."""
    counts = _read_counts() if counts is None else counts
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want or not any(want.values()):
        raise AssertionError(f"{path} launched {counts}, expected {want}")
    return counts


def phase_kernel_vs_plain(A, golden_hub, hub, tag: str = "K1"):
    import numpy as np
    import torch

    from graphblast_tpu_torch.ops.kernels.bitmap_pull import (
        pack_bitmap, plan_for_bitmap, spmv_bitmap_pull,
        spmv_bitmap_pull_plain)

    plan = plan_for_bitmap(A, transpose=True)
    old = _warp_rows(plan)
    n = A.nrows
    nnz = int(plan.ptr[-1])
    frontiers = {
        "hub": np.eye(1, n, hub, dtype=np.float32)[0],
        "hub_level2": (golden_hub == 2).astype(np.float32),
        "random20": (np.random.RandomState(42).rand(n) < 0.2).astype(
            np.float32),
    }
    # the BFS iteration whose visited mask goes with each frontier
    visited_through = {"hub": 1, "hub_level2": 2, "random20": 2}
    lib_mat = torch.sparse_csr_tensor(
        plan.ptr, plan.ind[:nnz],
        torch.ones(nnz, dtype=torch.float32, device="cuda"),
        size=(plan.n_out, plan.n_in), check_invariants=False)
    n_words = (plan.n_in + 31) // 32
    bound_bytes = 4 * (nnz + (plan.n_out + 1) + n_words + plan.n_out)
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] n_out={plan.n_out} n_in={plan.n_in} nnz={nnz} "
          f"words={n_words} bound {bound_bytes} B -> {bound_ms:.6f} ms "
          "at 3.35 TB/s")
    print(f"[{tag}] schedule (the CSC's, shared): "
          f"{_schedule_text(plan.sched)}")
    rows = {}
    for name, f_np in frontiers.items():
        f = torch.from_numpy(f_np).cuda()
        words = pack_bitmap(f)
        y = spmv_bitmap_pull(plan, words)
        y_again = spmv_bitmap_pull(plan, words)
        y_old = spmv_bitmap_pull(old, words)
        y_plain = spmv_bitmap_pull_plain(plan, words)
        y_lib = torch.mv(lib_mat, f)
        torch.cuda.synchronize()
        err = int((y - y_plain).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"{tag} != plain on {name}: max diff {err}")
        if not (torch.equal(y, y_again) and torch.equal(y_old, y_plain)):
            raise AssertionError(f"{tag} on {name}: differs from a second "
                                 "launch or, one warp a row, from plain")
        if not torch.equal(y_lib.round().to(torch.int32), y):
            raise AssertionError(f"{tag} != torch.sparse counts on {name}")
        ms = _event_ms(lambda: spmv_bitmap_pull(plan, words), 200)
        plain_ms = _event_ms(lambda: spmv_bitmap_pull_plain(plan, words), 20)
        lib_ms = _event_ms(lambda: torch.mv(lib_mat, f), 50)
        old_ms = _event_ms(lambda: spmv_bitmap_pull(old, words), 200)
        ms_again = _event_ms(lambda: spmv_bitmap_pull(plan, words), 200)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms)
        print(f"[{tag}] {name}: frontier={int(f_np.sum())} "
              f"sum(y)={int(y.sum())} equal to plain (max diff {err}), to "
              f"a second launch and to torch.sparse; kernel {ms:.6f} ms "
              f"(again: {ms_again:.6f}), one warp a row (the first "
              f"schedule, this kernel) {old_ms:.6f} ms ({old_ms / ms:.2f}x), "
              f"plain {plain_ms:.6f} ms, torch.sparse {lib_ms:.6f} ms, bound "
              f"{bound_ms:.6f} ms")
        rows[name]["masked"] = _masked_vs_count(
            tag, name, plan, words, y, golden_hub, visited_through[name],
            f_np, ms)
    return rows, bound_ms


def _masked_vs_count(tag, name, plan, words, count, golden, it, f_np,
                     count_ms):
    """K1's masked entry under BFS's visited mask of iteration `it` (the
    golden levels 1 .. it, complemented) beside K1's count: equal to
    (count > 0) & the mask's pass, to its plain version and to a second
    launch, bitwise; timed with its plain version and its least bytes."""
    import dataclasses

    import numpy as np
    import torch

    from graphblast_tpu_torch.ops.kernels.bitmap_pull import (
        spmv_bitmap_pull, spmv_bitmap_pull_plain)

    level = np.where((golden >= 1) & (golden <= it), golden, 0)
    mask = torch.from_numpy(level.astype(np.float32)).cuda()
    masked = dataclasses.replace(plan, mask=mask, mask_scmp=True)
    launches = spmv_bitmap_pull.masked_launches
    y = spmv_bitmap_pull(masked, words)
    y_again = spmv_bitmap_pull(masked, words)
    y_plain = spmv_bitmap_pull_plain(masked, words)
    torch.cuda.synchronize()
    if spmv_bitmap_pull.masked_launches != launches + 2:
        raise AssertionError(f"{tag} masked on {name}: "
                             f"{spmv_bitmap_pull.masked_launches - launches}"
                             " masked launches, not 2")
    want = ((count > 0) & (mask == 0)).to(torch.int32)
    if not (torch.equal(y, want) and torch.equal(y, y_plain)
            and torch.equal(y, y_again)):
        raise AssertionError(f"{tag} masked on {name}: differs from (count "
                             "> 0) & pass, its plain version or a second "
                             "launch")
    ms = _event_ms(lambda: spmv_bitmap_pull(masked, words), 200)
    plain_ms = _event_ms(lambda: spmv_bitmap_pull_plain(masked, words), 20)
    least = _orpull_least_bytes(plan, torch.from_numpy(level).cuda(),
                                torch.from_numpy(f_np).cuda() != 0)
    least_ms = least / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] {name} masked (visited = levels 1..{it}, "
          f"{int((level > 0).sum())} rows closed): sum(y)={int(y.sum())} "
          f"equal to (count > 0) & pass, its plain version and a second "
          f"launch; masked {ms:.6f} ms, count {count_ms:.6f} ms "
          f"({count_ms / ms:.2f}x), plain {plain_ms:.6f} ms; least bytes "
          f"{least} -> {least_ms:.6f} ms ({100 * least_ms / ms:.2f}% of its "
          "roofline)")
    return dict(ms=ms, plain_ms=plain_ms, least_bytes=least,
                least_ms=least_ms)


def _orpull_least_bytes(plan, level, frontier) -> int:
    """The least bytes of the masked or-pull over `plan` (the benchmark's
    model): 4 B an id of each open row (level 0) up to and including its
    first frontier id (all of the row where none is), 4 B each row pointer
    that bounds an open row, and n/8 B for each of the frontier's, the
    mask's and the result's bitmaps."""
    import torch

    ptr = plan.ptr.long()
    length = ptr[1:] - ptr[:-1]
    nnz = int(ptr[-1])
    rows = torch.repeat_interleave(torch.arange(plan.n_out, device="cuda"),
                                   length, output_size=nnz)
    opened = level == 0
    hit = frontier[plan.ind[:nnz].long()] & opened[rows]
    first = length.clone()
    pos = torch.arange(nnz, device="cuda") - ptr[rows]
    first.scatter_reduce_(0, rows[hit], pos[hit], reduce="amin")
    scanned = torch.where(first < length, first + 1, length)
    bounds = torch.zeros(plan.n_out + 1, dtype=torch.bool, device="cuda")
    bounds[:-1] |= opened
    bounds[1:] |= opened
    return (4 * int(scanned[opened].sum()) + 4 * int(bounds.sum())
            + 3 * ((plan.n_out + 7) // 8))


def phase_main_path(A, sources, goldens, reps: int = 10,
                    label: str = "rmat18"):
    import numpy as np

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.bfs import bfs_pull_plan

    desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PULLONLY)
    bfs = gt.algorithms.bfs
    _reset_counts()
    levels = [bfs(A, int(s), desc).to_numpy() for s in sources]
    iters = [int(v.max()) for v in levels]   # one K1 launch per iteration
    launches = _expect_launches("BFS", {"bitmap_pull": sum(iters)})[
        "bitmap_pull"]
    _expect_shared_schedule("BFS", bfs_pull_plan(A, desc), A, "csc")
    for s, v, want in zip(sources, levels, goldens):
        if v.shape != (A.nrows,) or not np.isfinite(v).all():
            raise AssertionError(f"BFS from {s}: bad levels array")
        bad = int((v != want).sum())
        if bad:
            raise AssertionError(f"BFS from {s}: {bad} levels != golden")
    print(f"[bfs] {len(sources)} sources: levels == NumPy golden; "
          f"iterations {iters}; K1 launches {launches}")

    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(lambda: bfs(A, next(srcs), desc),
                                   len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached_edges = int(deg[levels[0] != 0].sum())
    reached = int((levels[0] != 0).sum())
    print(f"[bfs] pull-only {label}: {per_s * 1e3:.6f} ms/run median, "
          f"{tail}, {len(sources) * reps} runs "
          f"({len(sources)} sources x {reps}); reached {reached} vertices, "
          f"{reached_edges} edges; {reached_edges / per_s / 1e9:.6f} GTEPS "
          f"at the median; {iters[0]} iterations")
    return launches, per_s, iters


def _warp_rows(plan, rows=None):
    """The plan (value, monoid or bitmap) with a schedule that puts `rows`
    (all, in row order, by default) in the medium bin, one warp a row, and
    launches nothing else. With every row it is the first design's
    schedule: the redesigned kernel then walks each row as the first design
    did, through perm and with its own four-edge loop. With some rows it
    times those alone (the other rows' y is left unwritten)."""
    import dataclasses

    import torch

    from graphblast_tpu_torch.ops.kernels.row_schedule import (N_BINS,
                                                               RowSchedule)

    dev = plan.ptr.device
    if rows is None:
        rows = torch.arange(plan.n_out, dtype=torch.int32, device=dev)
    n = rows.shape[0]
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    blocks = -(-n // 8)
    return dataclasses.replace(plan, sched=RowSchedule(
        perm=rows, bin_begin=(0, 0) + (n,) * (N_BINS - 1), chunk_beg=empty,
        block_begin=(0, 0) + (blocks,) * (N_BINS - 1)))


def _schedule_text(s) -> str:
    """A RowSchedule's rows per bin, long rows, chunks and blocks."""
    from graphblast_tpu_torch.ops.kernels.row_schedule import (CLUSTER,
                                                               LONG_ROW)

    return (f"rows per bin (long, medium, <=32, <=16, <=8, <=4 edges) "
            f"{list(s.bin_rows)}; {s.bin_rows[0]} long rows (T = {LONG_ROW})"
            f" in {s.n_chunks} chunks, {CLUSTER} a row (one cluster); "
            f"{s.blocks} blocks")


def _expect_shared_schedule(path: str, plan, A, orient: str):
    """Raises unless `plan` reads the schedule cached for `orient` on A,
    the one every plan of that orientation shares (it built none)."""
    if plan.sched is None or plan.sched is not A._plans.get(
            orient + "/schedule"):
        raise AssertionError(f"{path}: the plan built its own schedule, not "
                             f"A._plans[{orient + '/schedule'!r}]")


def _bin_alone(plan, b: int):
    """The plan with a schedule that launches only bin b's blocks (the
    other rows' y is left unwritten): a bin's share of the call."""
    import dataclasses

    import numpy as np

    from graphblast_tpu_torch.ops.kernels.row_schedule import N_BINS

    s = plan.sched
    blocks = [s.block_begin[i + 1] - s.block_begin[i] if i == b else 0
              for i in range(N_BINS)]
    return dataclasses.replace(plan, sched=dataclasses.replace(
        s, block_begin=tuple(np.cumsum([0] + blocks).tolist())))


def phase_value_pull(tag, plan, x, plain_reps: int):
    """The value pull against its plain version and itself, timed beside
    the plain version, torch.mv on the same CSR (a yardstick only) and
    the first design's schedule (one warp a row); its row schedule and the
    schedule's build time; the longest row alone; each bin alone; and the
    medium bin's rows alone by length."""
    import torch

    from graphblast_tpu_torch.ops.kernels.row_schedule import (
        LONG_ROW, build_schedule)
    from graphblast_tpu_torch.ops.kernels.value_pull import (
        build_plan, spmv_value_pull, spmv_value_pull_plain)

    nnz = int(plan.ptr[-1])
    y = spmv_value_pull(plan, x)
    y_again = spmv_value_pull(plan, x)
    y_plain = spmv_value_pull_plain(plan, x)
    lib_mat = torch.sparse_csr_tensor(plan.ptr, plan.ind[:nnz],
                                      plan.val[:nnz],
                                      size=(plan.n_out, plan.n_in),
                                      check_invariants=False)
    y_lib = torch.mv(lib_mat, x)
    old = _warp_rows(plan)
    y_old = spmv_value_pull(old, x)
    torch.cuda.synchronize()
    if y.shape != (plan.n_out,) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{tag}: bad output")
    scale = float(y_plain.abs().max())
    err = float((y - y_plain).abs().max())
    old_err = float((y_old - y_plain).abs().max())
    if not max(err, old_err) <= 1e-5 * scale:
        raise AssertionError(f"{tag}: max |y - y_plain| = {err} (one warp "
                             f"a row: {old_err}) > 1e-5 * {scale}")
    if not torch.equal(y, y_again):
        raise AssertionError(f"{tag}: two launches differ")
    lib_err = float((y_lib - y_plain).abs().max())
    s = plan.sched
    build_s, _ = _timed_runs(lambda: build_schedule(plan.ptr), 5)
    print(f"[{tag}] schedule: {_schedule_text(s)}; built in "
          f"{build_s * 1e3:.6f} ms on the card (median of 5)")
    bound_bytes = 8 * nnz + 4 * (plan.n_out + 1) + 4 * plan.n_in \
        + 4 * plan.n_out
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    ms = _event_ms(lambda: spmv_value_pull(plan, x), 200)
    plain_ms = _event_ms(lambda: spmv_value_pull_plain(plan, x), plain_reps)
    lib_ms = _event_ms(lambda: torch.mv(lib_mat, x), 50)
    old_ms = _event_ms(lambda: spmv_value_pull(old, x), 200)
    ms_again = _event_ms(lambda: spmv_value_pull(plan, x), 200)
    print(f"[{tag}] n_out={plan.n_out} n_in={plan.n_in} nnz={nnz}; "
          f"max|y_plain| {scale:.6g}, kernel max abs err {err:.6g} "
          f"(rel {err / scale:.3g}, bar 1e-5), bitwise equal to a second "
          f"launch; torch.mv max abs err {lib_err:.6g}")
    print(f"[{tag}] kernel {ms:.6f} ms (again after the rest: "
          f"{ms_again:.6f}), one warp a row (the first schedule, this "
          f"kernel) {old_ms:.6f} ms ({old_ms / ms:.2f}x), plain "
          f"{plain_ms:.6f} ms, torch.mv {lib_ms:.6f} ms "
          f"({lib_ms / ms:.2f}x the kernel's time), bound "
          f"{bound_bytes} B -> {bound_ms:.6f} ms at 3.35 TB/s "
          f"({100 * bound_ms / ms:.1f}% of it)")
    # the longest row alone, a one-row plan: a long row's chunks run on
    # one cluster of blocks, beside the rest of the call
    deg = plan.ptr[1:] - plan.ptr[:-1]
    i = int(torch.argmax(deg))
    b, e = int(plan.ptr[i]), int(plan.ptr[i + 1])
    row = build_plan(torch.tensor([0, e - b], dtype=plan.ptr.dtype,
                                  device=x.device),
                     plan.ind[b:e], plan.val[b:e], 1, plan.n_in)
    row_ms = _event_ms(lambda: spmv_value_pull(row, x), 200)
    print(f"[{tag}] longest row ({e - b} edges) alone: {row_ms:.6f} ms in "
          f"{row.sched.blocks} block(s) ({row.sched.n_chunks} chunks), "
          f"{100 * row_ms / ms:.1f}% of the whole call")
    # each bin alone, with its edges
    length = (plan.ptr[1:] - plan.ptr[:-1]).long()[s.perm.long()]
    parts = []
    for b, name in enumerate(("long", "medium", "<=32", "<=16", "<=8",
                              "<=4")):
        lo, hi = s.bin_begin[b], s.bin_begin[b + 1]
        if hi == lo:
            continue
        only = _bin_alone(plan, b)
        b_ms = _event_ms(lambda: spmv_value_pull(only, x), 200)
        parts.append(f"{name} {int(length[lo:hi].sum())} edges "
                     f"{b_ms:.6f} ms")
    print(f"[{tag}] each bin alone: " + "; ".join(parts))
    # the medium bin's rows alone by length: whether a tail of warps on
    # rows of thousands of edges holds the bin back
    medium = s.perm[s.bin_begin[1]:s.bin_begin[2]]
    m_len = length[s.bin_begin[1]:s.bin_begin[2]]
    parts = []
    for lo, hi in ((33, 256), (257, 1024), (1025, 4096), (4097, LONG_ROW)):
        pick = (m_len >= lo) & (m_len <= hi)
        if not bool(pick.any()):
            continue
        only = _warp_rows(plan, medium[pick])
        r_ms = _event_ms(lambda: spmv_value_pull(only, x), 200)
        parts.append(f"{lo}-{hi} edges: {int(pick.sum())} rows, "
                     f"{int(m_len[pick].sum())} edges, {r_ms:.6f} ms")
    if parts:
        print(f"[{tag}] medium rows alone by length: " + "; ".join(parts))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=lib_ms)


def phase_pagerank(A, reps: int = 40):
    """PageRank through the entry point, against the port's golden at its
    fixed point; then the call, its host plan build and its loop, timed.
    Returns (value-pull launches, the golden)."""
    import numpy as np

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.pr import _pr_fused, prepare_pr_plan
    from graphblast_tpu_torch.ops.kernels.value_pull import spmv_value_pull

    t0 = time.perf_counter()
    gold = gt.algorithms.pr_cpu(A, PR_ALPHA, eps=1e-14, max_niter=300)
    print(f"[pr] NumPy golden in {time.perf_counter() - t0:.2f} s")

    _reset_counts()
    p = gt.algorithms.pr(A, alpha=PR_ALPHA, eps=PR_EPS).to_numpy()
    counts = _read_counts()
    if p.shape != (A.nrows,) or not np.isfinite(p).all():
        raise AssertionError("PageRank: bad rank array")
    l1 = float(np.abs(p.astype(np.float64) - gold).sum())
    top = np.argsort(gold)[::-1][:100]
    top_rel = float((np.abs(p[top] - gold[top]) / gold[top]).max())
    if not (l1 <= 1e-4 and top_rel <= 1e-3):
        raise AssertionError(f"PageRank vs golden: L1 {l1} (bar 1e-4), "
                             f"top-100 rel {top_rel} (bar 1e-3)")
    # the loop is deterministic: a second run gives the iteration count
    plan = prepare_pr_plan(A, PR_ALPHA)
    p2, iters, err = _pr_fused(A, plan, alpha=PR_ALPHA, eps=PR_EPS,
                               max_niter=gt.DEFAULT.max_niter)
    if not np.array_equal(p2.cpu().numpy(), p):
        raise AssertionError("PageRank: two runs differ")
    launches = _expect_launches("PageRank", {"value_pull": iters}, counts)[
        "value_pull"]
    _expect_shared_schedule("PageRank", plan, A, "csc")
    print(f"[pr] rmat18 alpha {PR_ALPHA} eps {PR_EPS}: {iters} iterations, "
          f"last err {err:.3e}; sum|p - p_gold| {l1:.3e} (bar 1e-4), top-100 "
          f"max rel err {top_rel:.3e} (bar 1e-3), sum p {p.sum():.6f}; "
          f"value-pull launches {launches}")

    call_s, call_tail = _timed_runs(
        lambda: gt.algorithms.pr(A, alpha=PR_ALPHA, eps=PR_EPS), reps)
    plan_s, _ = _timed_runs(lambda: prepare_pr_plan(A, PR_ALPHA), 10)
    loop_s, loop_tail = _timed_runs(
        lambda: _pr_fused(A, plan, alpha=PR_ALPHA, eps=PR_EPS,
                          max_niter=gt.DEFAULT.max_niter), reps)
    k_ms = _event_ms(lambda: spmv_value_pull(plan, p2), 200)
    it_ms = loop_s * 1e3 / iters
    print(f"[pr] pr() call {call_s * 1e3:.6f} ms median, {call_tail}, "
          f"{reps} runs; host plan build "
          f"(prepare_pr_plan) {plan_s * 1e3:.6f} ms median of 10; loop "
          f"{loop_s * 1e3:.6f} ms median, {loop_tail}, {reps} runs")
    print(f"[pr] {it_ms:.6f} ms/iteration in the loop, pr_iters_per_s "
          f"{iters / loop_s:.2f} (loop) {iters / call_s:.2f} (whole call); "
          f"kernel {k_ms:.6f} ms x {iters} = {k_ms * iters:.6f} ms, "
          f"{100 * k_ms * iters / (loop_s * 1e3):.2f}% of the loop, "
          f"{100 * k_ms * iters / (call_s * 1e3):.2f}% of the call; host and "
          f"other ops {it_ms - k_ms:.6f} ms/iteration")
    return launches, gold


def phase_monoid_pull(A):
    """K4 at RMAT scale 18 for each semiring of its map, against its plain
    version (tolerance 0), a second launch and one warp a row; its
    schedules; times (beside one warp a row) and bounds."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops.kernels.monoid_pull import (
        FLT_MAX, build_plan_monoid, plan_for_monoid, spmv_monoid,
        spmv_monoid_plain)
    from graphblast_tpu_torch.ops.kernels.row_schedule import schedule_for

    n = A.nrows
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, A.nvals).astype(
        np.float32)).cuda()
    csc = build_plan_monoid(A.col_ptr, A.csc_row_ind, w, n, n,
                            schedule_for(A, transpose=True))
    x_sssp = np.where(rng.random(n) < 0.4, np.float32(FLT_MAX),
                      rng.uniform(0.0, 5.0, n)).astype(np.float32)
    x_uniform = rng.uniform(0.0, 5.0, n).astype(np.float32)
    cases = [
        ("min_plus", gt.MinimumPlusSemiring, csc, x_sssp),
        ("min_select_second", gt.MinimumSelectSecondSemiring,
         plan_for_monoid(A, ones=True), np.arange(n, dtype=np.float32)),
        ("min_mul", gt.MinimumMultipliesSemiring, csc, x_uniform),
        ("max_mul", gt.MaximumMultipliesSemiring, csc, x_uniform),
    ]
    for orient, plan in (("CSC", csc), ("CSR", cases[1][2])):
        print(f"[K4] schedule of the {orient} (shared): "
              f"{_schedule_text(plan.sched)}")
    rows = {}
    for name, sr, plan, x_np in cases:
        x = torch.from_numpy(x_np).cuda()
        nnz = int(plan.ptr[-1])
        old = _warp_rows(plan)
        y = spmv_monoid(plan, x, sr)
        y_again = spmv_monoid(plan, x, sr)
        y_old = spmv_monoid(old, x, sr)
        y_plain = spmv_monoid_plain(plan, x, sr)
        torch.cuda.synchronize()
        if y.shape != (plan.n_out,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"K4 {name}: bad output")
        err = float((y - y_plain).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"K4 {name} != plain: max diff {err}")
        if not torch.equal(y, y_again):
            raise AssertionError(f"K4 {name}: two launches differ")
        if not torch.equal(y_old, y_plain):
            raise AssertionError(f"K4 {name}, one warp a row, != plain")
        # ind, val (none on the unit plan), ptr, x and y, each once
        vals = 0 if plan.val is None else 4
        bound_bytes = (4 + vals) * nnz + 4 * (plan.n_out + 1) \
            + 4 * plan.n_in + 4 * plan.n_out
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ms = _event_ms(lambda: spmv_monoid(plan, x, sr), 200)
        plain_ms = _event_ms(lambda: spmv_monoid_plain(plan, x, sr), 20)
        old_ms = _event_ms(lambda: spmv_monoid(old, x, sr), 200)
        ms_again = _event_ms(lambda: spmv_monoid(plan, x, sr), 200)
        deg = plan.ptr[1:] - plan.ptr[:-1]
        i = int(torch.argmax(deg))
        b, e = int(plan.ptr[i]), int(plan.ptr[i + 1])
        row = build_plan_monoid(
            torch.tensor([0, e - b], dtype=plan.ptr.dtype, device=x.device),
            plan.ind[b:e], None if plan.val is None else plan.val[b:e], 1,
            plan.n_in)
        row_ms = _event_ms(lambda: spmv_monoid(row, x, sr), 200)
        identity = int((y == float(sr.identity(torch.float32))).sum())
        print(f"[K4 {name}] n_out={plan.n_out} n_in={plan.n_in} nnz={nnz}; "
              f"equal to plain (max diff {err}), to a second launch and to "
              f"one warp a row; {identity} rows at the identity")
        print(f"[K4 {name}] kernel {ms:.6f} ms (again: {ms_again:.6f}), one "
              f"warp a row (the first schedule, this kernel) {old_ms:.6f} ms "
              f"({old_ms / ms:.2f}x), plain {plain_ms:.6f} ms, bound "
              f"{bound_bytes} B -> {bound_ms:.6f} ms at 3.35 TB/s "
              f"({100 * bound_ms / ms:.1f}% of it); longest row ({e - b} "
              f"edges) alone {row_ms:.6f} ms in {row.sched.blocks} block(s), "
              f"{100 * row_ms / ms:.1f}% of the whole call")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, library_ms=None)
    rows["min_plus_masked"] = _masked_min_plus(csc, torch.from_numpy(
        x_sssp).cuda())
    return rows


def _monoid_least_bytes(plan, x, b) -> int:
    """The least bytes of K4's masked MinimumPlus pull over `plan` at x
    under the bound b: 4 B an id of each open row and 8 B more (x and the
    weight) at each of its frontier columns, 4 B each row pointer that
    bounds an open row, 8 B a row (the bound read, y written) and the
    frontier's bitmap (n_in / 8 B)."""
    import torch

    from graphblast_tpu_torch.ops.kernels.monoid_pull import (
        FLT_MAX, pull_threshold)

    ptr = plan.ptr.long()
    length = ptr[1:] - ptr[:-1]
    nnz = int(ptr[-1])
    rows = torch.repeat_interleave(torch.arange(plan.n_out, device="cuda"),
                                   length, output_size=nnz)
    opened = ~(b <= pull_threshold(plan, x))
    on = (x != FLT_MAX)[plan.ind[:nnz].long()] & opened[rows]
    bounds = torch.zeros(plan.n_out + 1, dtype=torch.bool, device="cuda")
    bounds[:-1] |= opened
    bounds[1:] |= opened
    return (4 * int(length[opened].sum()) + 8 * int(on.sum())
            + 4 * int(bounds.sum()) + 8 * plan.n_out + (plan.n_in + 7) // 8)


def _masked_min_plus(plan, x_sssp):
    """K4's masked entry (SSSP's pull, `spmv_monoid(..., bound=)`) over
    the weighted CSC: at each step of a pull-only relaxation from the
    CSC's longest row (its frontier, under its distances v), then at
    x_sssp under the last step's v. Each must be torch.equal to its plain
    version given the bound and to a second launch, equal to the unmasked
    K4 after SSSP's filter where(y < v, y, FLT_MAX), and count one launch
    in spmv_monoid.launches and .masked_launches; each is timed (the pull
    as the path calls it: the bitmap pack, the threshold and the launch)
    beside the unmasked K4 and its plain version, with its least bytes.
    Returns x_sssp's row of the kernels line."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops.kernels.monoid_pull import (
        FLT_MAX, pull_threshold, spmv_monoid, spmv_monoid_plain)

    sr = gt.MinimumPlusSemiring

    def check(tag, x, b):
        launches = spmv_monoid.launches
        masked = spmv_monoid.masked_launches
        y = spmv_monoid(plan, x, sr, bound=b)
        y_again = spmv_monoid(plan, x, sr, bound=b)
        counted = (spmv_monoid.launches - launches,
                   spmv_monoid.masked_launches - masked)
        y_plain = spmv_monoid_plain(plan, x, sr, b)
        y_full = spmv_monoid(plan, x, sr)
        torch.cuda.synchronize()
        if counted != (2, 2):
            raise AssertionError(f"K4 masked {tag}: counted {counted}, not "
                                 "2 launches, both masked")
        err = float((y - y_plain).abs().max())
        if not (torch.equal(y, y_plain) and torch.equal(y, y_again)):
            raise AssertionError(f"K4 masked {tag}: differs from its plain "
                                 f"version (max diff {err}) or a second "
                                 "launch")
        if not torch.equal(torch.where(y < b, y, FLT_MAX),
                           torch.where(y_full < b, y_full, FLT_MAX)):
            raise AssertionError(f"K4 masked {tag}: differs from the "
                                 "unmasked K4 after the filter")
        ms = _event_ms(lambda: spmv_monoid(plan, x, sr, bound=b), 200)
        full_ms = _event_ms(lambda: spmv_monoid(plan, x, sr), 200)
        plain_ms = _event_ms(lambda: spmv_monoid_plain(plan, x, sr, b), 20)
        least = _monoid_least_bytes(plan, x, b)
        least_ms = least / HBM_BYTES_PER_S * 1e3
        closed = int((b <= pull_threshold(plan, x)).sum())
        print(f"[K4 masked] {tag}: frontier {int((x != FLT_MAX).sum())}, "
              f"{closed} rows closed, {int((y < b).sum())} rows lowered; "
              f"equal to plain, a second launch and the filtered unmasked "
              f"K4; masked {ms:.6f} ms, unmasked {full_ms:.6f} ms "
              f"({full_ms / ms:.2f}x), plain {plain_ms:.6f} ms; least bytes "
              f"{least} -> {least_ms:.6f} ms ({100 * least_ms / ms:.2f}% of "
              "its roofline)")
        return y, full_ms, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=least_ms, library_ms=None)

    n = plan.n_out
    v = torch.full((n,), FLT_MAX, device="cuda")
    v[int(torch.argmax(plan.ptr[1:] - plan.ptr[:-1]))] = 0.0
    f, masked_ms, full_ms, pulls = v.clone(), 0.0, 0.0, 0
    while pulls < 12 and bool((f != FLT_MAX).any()):
        pulls += 1
        y, step_full_ms, row = check(f"relaxation {pulls}", f, v)
        masked_ms += row["ms"]
        full_ms += step_full_ms
        f = torch.where(y < v, y, FLT_MAX)
        v = torch.minimum(v, f)
    print(f"[K4 masked] the relaxation's {pulls} pulls: masked "
          f"{masked_ms:.6f} ms, unmasked {full_ms:.6f} ms "
          f"({full_ms / masked_ms:.2f}x)")
    return check("x_sssp", x_sssp, v)[2]


def phase_sssp(A, sources, k4_ms: float, reps: int = 10):
    """Pull-only SSSP through the entry point from the hub sources, against
    the port's golden, one K4 launch per iteration, each through the masked
    entry; then timed. Returns (masked launches, unmasked MinimumPlus
    launches, goldens, s/run)."""
    import numpy as np

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused
    from graphblast_tpu_torch.ops.kernels.monoid_pull import (
        FLT_MAX, plan_for_monoid)

    desc = gt.DEFAULT.replace(mxv_mode=gt.Direction.PULLONLY)
    t0 = time.perf_counter()
    goldens = [gt.algorithms.sssp_cpu(A, int(s)) for s in sources]
    print(f"[sssp] NumPy goldens in {time.perf_counter() - t0:.2f} s")
    _reset_counts()
    dists = [gt.algorithms.sssp(A, int(s), desc).to_numpy() for s in sources]
    counts = _read_counts()
    plan = plan_for_monoid(A, transpose=True)
    iters = [_sssp_fused(A, int(s), plan, switchpoint=desc.switchpoint,
                         mode=desc.mxv_mode, max_niter=desc.max_niter)[1]
             for s in sources]
    for s, d, want in zip(sources, dists, goldens):
        if d.shape != (A.nrows,) or not np.isfinite(d).all():
            raise AssertionError(f"SSSP from {s}: bad distance array")
        bad = int((d != want).sum())
        if bad:
            raise AssertionError(f"SSSP from {s}: {bad} distances != golden")
    counts = _expect_launches("SSSP", {"monoid_pull": sum(iters),
                                       "monoid_pull_masked": sum(iters)},
                              counts)
    launches = counts["monoid_pull_masked"]
    _expect_shared_schedule("SSSP", plan, A, "csc")
    print(f"[sssp] {len(sources)} sources: distances == NumPy golden; "
          f"iterations {iters}; K4 launches {launches}, all masked")
    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(
        lambda: gt.algorithms.sssp(A, next(srcs), desc),
        len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached = dists[0] < FLT_MAX
    reached_edges = int(deg[reached].sum())
    k4 = iters[0] * k4_ms
    print(f"[sssp] pull-only rmat18: {per_s * 1e3:.6f} ms/run median, "
          f"{tail}, {len(sources) * reps} runs "
          f"({len(sources)} sources x {reps}); reached {int(reached.sum())} "
          f"vertices, {reached_edges} edges; "
          f"{reached_edges / per_s / 1e9:.6f} GTEPS at the median; "
          f"{iters[0]} iterations")
    print(f"[sssp] K4 time per run ({iters[0]} launches x {k4_ms:.6f} ms, "
          f"min_plus_masked at x_sssp above) = {k4:.6f} ms, "
          f"{100 * k4 / (per_s * 1e3):.2f}% of the median run")
    return launches, counts["monoid_pull"] - launches, goldens, per_s


def phase_cc(A, k4_ms: float, reps: int = 40):
    """FastSV CC through the entry point against the port's golden and
    verify_cc, one K4 launch per iteration; then timed."""
    import numpy as np

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.cc import _cc_fused
    from graphblast_tpu_torch.ops.kernels.monoid_pull import plan_for_monoid

    t0 = time.perf_counter()
    golden = gt.algorithms.cc_cpu(A)
    print(f"[cc] NumPy golden in {time.perf_counter() - t0:.2f} s")
    _reset_counts()
    labels = gt.algorithms.cc(A).to_numpy()
    counts = _read_counts()
    plan = plan_for_monoid(A, ones=True)
    _, iters = _cc_fused(A, plan, max_niter=gt.DEFAULT.max_niter)
    if labels.shape != (A.nrows,):
        raise AssertionError("CC: bad label array")
    bad = int((labels != golden).sum())
    if bad or not gt.algorithms.verify_cc(A, labels):
        raise AssertionError(f"CC: {bad} labels != golden, or verify_cc "
                             "fails")
    launches = _expect_launches("CC", {"monoid_pull": iters}, counts)[
        "monoid_pull"]
    _expect_shared_schedule("CC", plan, A, "csr")
    comps = len(np.unique(labels))
    print(f"[cc] rmat18: labels == NumPy golden, verify_cc holds; {comps} "
          f"components; {iters} iterations; K4 launches {launches}")
    per_s, tail = _timed_runs(lambda: gt.algorithms.cc(A), reps)
    k4 = iters * k4_ms
    print(f"[cc] {per_s * 1e3:.6f} ms/run median, {tail}, {reps} runs; "
          f"cc_gteps "
          f"{A.nvals * iters / per_s / 1e9:.6f} (nvals x iterations / "
          f"median)")
    print(f"[cc] K4 time per run ({iters} launches x {k4_ms:.6f} ms, "
          f"min_select_second above) = {k4:.6f} ms, "
          f"{100 * k4 / (per_s * 1e3):.2f}% of the median run")
    return launches, golden, per_s


def _k6_launch_costs(table, idx, calls: int = 10_000):
    """Host µs a call of K6's launch path and of each of its pieces, over
    `calls` back-to-back calls (host clock, one synchronize at the end):
    the wrapper, torch.index_select, the first launch path's lines
    (rebuilt here: device objects in the check, torch.empty with a
    device, the library lookup, a device guard, the stream object, the
    ctypes call, two counter updates) and each piece alone."""
    import ctypes

    import torch

    from graphblast_tpu_torch.ops.kernels import _build, gather

    sigs = {"gb_gather": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                          + [ctypes.c_void_p], ctypes.c_int)}
    lib = _build.load("gather", sigs)
    m, n, dev = idx.shape[0], table.shape[0], table.get_device()
    y = torch.empty_like(idx)
    raw_stream = torch._C._cuda_getCurrentRawStream
    stream = raw_stream(dev)
    args = (table.data_ptr(), idx.data_ptr(), y.data_ptr(), m, n)
    # the first path's two counter updates, on an object of their own so
    # that gather_1d's counts stay its launches
    counted = types.SimpleNamespace(launches=0, sorted_launches=0)

    def first_wrapper():
        if table.device != idx.device:
            raise ValueError
        out = torch.empty(m, dtype=table.dtype, device=table.device)
        lib1 = _build.load("gather", sigs)
        with torch.cuda.device(table.device):
            s1 = torch.cuda.current_stream().cuda_stream
            err = lib1.gb_gather(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), m, n, s1)
        if err:
            raise RuntimeError(err)
        counted.launches += 1
        counted.sorted_launches += 0
        return out

    def counters():
        counted.launches += 1
        counted.sorted_launches += 1

    def guard():
        with torch.cuda.device(table.device):
            pass

    pieces = [
        ("wrapper gather_1d", lambda: gather.gather_1d(table, idx)),
        ("torch.index_select", lambda: torch.index_select(table, 0, idx)),
        ("first launch path", first_wrapper),
        ("_check", lambda: gather._check(table, idx)),
        ("x.device != idx.device", lambda: table.device != idx.device),
        ("torch.empty(device=x.device)",
         lambda: torch.empty(m, dtype=table.dtype, device=table.device)),
        ("x.new_empty", lambda: table.new_empty(m)),
        ("_build.load", lambda: _build.load("gather", sigs)),
        ("torch.cuda.device guard", guard),
        ("current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("raw stream", lambda: raw_stream(dev)),
        ("ctypes launch", lambda: lib.gb_gather(*args, stream)),
        ("launcher launch", lambda: gather._LAUNCH(dev, *args)),
        ("two counter updates", counters),
    ]
    out = {}
    for name, fn in pieces:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    print(f"[K6 launch] host us a call, {calls} back-to-back calls at the "
          f"row boundaries (m={m}): "
          + "; ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def phase_gather(A):
    """K6 at RMAT scale 18 at its call-site classes, the x class also over
    a misaligned slice, against its plain version (tolerance 0) and a
    second launch; times and bounds; the launch path's host costs."""
    import numpy as np
    import torch

    from graphblast_tpu_torch.ops.kernels.bitmap_pull import pack_bitmap
    from graphblast_tpu_torch.ops.kernels.gather import (gather_1d,
                                                         gather_1d_plain)

    n = A.nrows
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    csum = torch.from_numpy(np.cumsum(rng.random(A.nnz_pad) < 0.2).astype(
        np.int32)).cuda()
    words = pack_bitmap(torch.from_numpy(
        (rng.random(n) < 0.2).astype(np.float32)).cuda())
    col = A.csc_row_ind.contiguous()
    cases = [
        ("x", x, col),
        ("boundary", csum, (A.col_ptr - 1).clamp(min=0).contiguous()),
        ("words", words, (A.csc_row_ind >> 5).contiguous()),
        # a contiguous slice 4 bytes past an aligned start: the scalar path
        ("x_misaligned", x, col[1:]),
    ]
    rows = {}
    for name, table, idx in cases:
        m, nt = idx.shape[0], table.shape[0]
        y = gather_1d(table, idx)
        y_again = gather_1d(table, idx)
        y_plain = gather_1d_plain(table, idx)
        y_lib = torch.index_select(table, 0, idx)
        torch.cuda.synchronize()
        if y.shape != (m,) or y.dtype != table.dtype:
            raise AssertionError(f"K6 {name}: bad output")
        err = float((y.double() - y_plain.double()).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"K6 {name} != plain: max diff {err}")
        if not (torch.equal(y, y_again) and torch.equal(y, y_lib)):
            raise AssertionError(f"K6 {name}: differs from a second launch "
                                 "or from torch.index_select")
        # idx read, y written, and the table entries it can touch, once
        bound_bytes = 4 * (2 * m + min(nt, m))
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ms = _event_ms(lambda: gather_1d(table, idx), 200)
        plain_ms = _event_ms(lambda: gather_1d_plain(table, idx), 20)
        lib_ms = _event_ms(lambda: torch.index_select(table, 0, idx), 200)
        ms_again = _event_ms(lambda: gather_1d(table, idx), 200)
        dev = _device_ms(lambda: gather_1d(table, idx), 50,
                         ["gather_kernel", "gather4_kernel"])
        print(f"[K6 {name}] table {nt} x {table.dtype}, m={m}; equal to "
              f"plain (max diff {err}), to a second launch and to "
              "torch.index_select")
        print(f"[K6 {name}] kernel {ms:.6f} ms (again after "
              f"torch.index_select: {ms_again:.6f}), plain {plain_ms:.6f} "
              f"ms, torch.index_select {lib_ms:.6f} ms, bound {bound_bytes} "
              f"B -> {bound_ms:.6f} ms at 3.35 TB/s "
              f"({100 * bound_ms / ms:.1f}% of it); device time alone "
              f"(torch.profiler) {dev}")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, library_ms=lib_ms)
        if name == "boundary":
            _k6_launch_costs(table, idx)
    return rows


def phase_orpull(A, golden_hub):
    """K5 over the CSC's row ids at RMAT scale 18 on two frontiers, against
    its plain version (tolerance 0) and a second launch; times, device
    times and bound."""
    import numpy as np
    import torch

    from graphblast_tpu_torch.ops.kernels.bitmap_pull import pack_bitmap
    from graphblast_tpu_torch.ops.kernels.orpull import (
        orpull_bit_csum, orpull_bit_csum_plain)

    n = A.nrows
    col = A.csc_row_ind.contiguous()
    m = col.shape[0]
    frontiers = {
        "hub_level2": (golden_hub == 2).astype(np.float32),
        "random20": (np.random.RandomState(42).rand(n) < 0.2).astype(
            np.float32),
    }
    rows = {}
    for name, f_np in frontiers.items():
        words = pack_bitmap(torch.from_numpy(f_np).cuda())
        c = orpull_bit_csum(words, col)
        c_again = orpull_bit_csum(words, col)
        c_plain = orpull_bit_csum_plain(words, col)
        torch.cuda.synchronize()
        if c.shape != (m,) or c.dtype != torch.int32:
            raise AssertionError(f"K5 {name}: bad output")
        err = int((c.long() - c_plain.long()).abs().max())
        if not torch.equal(c, c_plain):
            raise AssertionError(f"K5 {name} != plain: max diff {err}")
        if not torch.equal(c, c_again):
            raise AssertionError(f"K5 {name}: two launches differ")
        # col_ind read, csum written and the bitmap read, once
        bound_bytes = 4 * (2 * m + words.shape[0])
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ms = _event_ms(lambda: orpull_bit_csum(words, col), 200)
        plain_ms = _event_ms(lambda: orpull_bit_csum_plain(words, col), 20)
        dev = _device_ms(lambda: orpull_bit_csum(words, col), 50,
                         ["orpull_csum_kernel"])
        dev_all = _device_ms(lambda: orpull_bit_csum(words, col), 50,
                             ["orpull_csum_kernel", "emset"])
        print(f"[K5 {name}] m={m} words={words.shape[0]} frontier="
              f"{int(f_np.sum())} csum[-1]={int(c[-1])}; equal to plain "
              f"(max diff {err}) and to a second launch")
        print(f"[K5 {name}] kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {bound_bytes} B -> {bound_ms:.6f} ms at 3.35 TB/s "
              f"({100 * bound_ms / ms:.1f}% of it); device time "
              f"(torch.profiler) of the one-pass kernel {dev}, with the "
              f"scratch memset {dev_all}")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, library_ms=None)
    return rows


def _same(a, b) -> bool:
    """Equal values of one dtype, NaN where the other is NaN (torch.equal
    alone counts NaN unequal; zeros compare up to their sign)."""
    import torch

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return (a.dtype == b.dtype and torch.equal(nan_a, nan_b)
            and torch.equal(a[~nan_a], b[~nan_b]))


def phase_minmax_pull(A):
    """S, the min/max row fold, at RMAT scale 18 for the five semirings
    with a min/max ⊕ on int32 and float32 frontiers, over the Matrix's
    cached schedules: MaximumMultiplies over the int32 CSC with MIS's
    first-round weights (and the masked pull against the old route),
    MinimumSelectSecond over the int32 CSR with the ids as x (plan-less
    CC's call site), the rest with x of every sign (int32) or with ±inf
    (float32). Each torch.equal to its plain version and to a second
    launch; timed beside the old route (the gather, then
    segment_reduce_csr's scan), torch.segment_reduce over the products
    and the bound."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.common import csc_int_arrays
    from graphblast_tpu_torch.algorithms.mis import random_weights
    from graphblast_tpu_torch.ops.gather_dispatch import take
    from graphblast_tpu_torch.ops.kernels.minmax_pull import (
        SEMIRING_MAP, spmv_minmax_pull, spmv_minmax_pull_plain)
    from graphblast_tpu_torch.ops.kernels.row_schedule import schedule_for
    from graphblast_tpu_torch.ops.segops import segment_reduce_csr
    from graphblast_tpu_torch.ops.spmv import spmv_pull

    n = A.nrows
    csc_ptr, csc_ind, csc_val, csc_sched = csc_int_arrays(A)
    csr_sched = schedule_for(A, transpose=False)
    for orient, sched in (("csc", csc_sched), ("csr", csr_sched)):
        if sched is not A._plans.get(orient + "/schedule"):
            raise AssertionError(f"S: the {orient} pull's schedule is not "
                                 f"A._plans[{orient + '/schedule'!r}]")
        print(f"[S] schedule of the {orient.upper()} (the Matrix's cached "
              f"one): {_schedule_text(sched)}")
    rng = np.random.default_rng(13)
    w = random_weights(n, 1, "cuda")      # MIS's first round, seed 1
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    x_int = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n).astype(
        np.int32)).cuda()
    x_f = rng.uniform(-5.0, 5.0, n).astype(np.float32)
    x_f[rng.random(n) < 0.1] = np.inf
    x_f[rng.random(n) < 0.1] = -np.inf
    x_float = torch.from_numpy(x_f).cuda()
    csc = (csc_ptr, csc_ind, csc_sched)
    csr = (A.row_ptr, A.col_ind, csr_sched)
    vals = {"csc": A.csc_val, "csr": A.val}
    cases = [("max_times", "MaximumMultiplies", "csc", w),
             ("min_second", "MinimumSelectSecond", "csr", ids)]
    cases += [(f"{tag}_int32", name, "csc", x_int) for tag, name in (
        ("min_plus", "MinimumPlus"), ("min_times", "MinimumMultiplies"),
        ("min_ne", "MinimumNotEqualTo"))]
    cases += [(f"{tag}_float32", name, "csc", x_float) for tag, name in (
        ("max_times", "MaximumMultiplies"), ("min_second",
                                             "MinimumSelectSecond"),
        ("min_plus", "MinimumPlus"), ("min_times", "MinimumMultiplies"),
        ("min_ne", "MinimumNotEqualTo"))]
    rows = {}
    for tag, name, orient, x in cases:
        sr = getattr(gt.semiring, f"{name}Semiring")
        ptr, ind, sched = csc if orient == "csc" else csr
        val = vals[orient].to(x.dtype)
        nnz = int(ptr[-1])
        y = spmv_minmax_pull(ptr, ind, val, x, sr, n, sched=sched)
        y_again = spmv_minmax_pull(ptr, ind, val, x, sr, n, sched=sched)
        y_plain = spmv_minmax_pull_plain(ptr, ind, val, x, sr, n)

        def old_route():
            edge = sr.mul(val, take(x, ind))
            return segment_reduce_csr(edge, ptr, sr.add, n)

        y_old = old_route()
        torch.cuda.synchronize()
        if y.shape != (n,) or y.dtype != x.dtype:
            raise AssertionError(f"S {tag}: bad output")
        if not (_same(y, y_plain) and _same(y, y_again)
                and _same(y, y_old)):
            raise AssertionError(f"S {tag}: differs from its plain version, "
                                 "a second launch or the old route")
        err = float((y.double() - y_plain.double()).abs().nan_to_num().max())
        if tag == "max_times":
            # MIS's masked pull through spmv_pull against the old route
            got = spmv_pull(ptr, ind, val, x, sr, n, mask_dense=x,
                            sched=sched)
            want = torch.where(x != 0, y_old, 0)
            if not torch.equal(got, want):
                raise AssertionError("S max_times: the masked pull differs "
                                     "from the old route")
        # the products beforehand, for torch.segment_reduce alone
        add = SEMIRING_MAP[name][0]
        prod = (take(x, ind) if SEMIRING_MAP[name][1] == "second"
                else sr.mul(val, take(x, ind)))[:nnz].contiguous()
        offsets = ptr.long()
        ident = sr.identity(x.dtype).item()
        lib_dtype = str(x.dtype).replace("torch.", "")
        try:
            torch.segment_reduce(prod, add, offsets=offsets, initial=ident)
        except (RuntimeError, NotImplementedError) as e:
            # a yardstick only: time it on float32
            lib_dtype = (f"float32 (refused {str(x.dtype)}: "
                         f"{str(e).splitlines()[0][:80]})")
            prod = prod.float()
        lib_ms = _event_ms(lambda: torch.segment_reduce(
            prod, add, offsets=offsets, initial=ident), 50)
        val_bytes = 0 if SEMIRING_MAP[name][1] == "second" else 4
        bound_bytes = (4 + val_bytes) * nnz + 4 * (n + 1) + 4 * n + 4 * n
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ms = _event_ms(lambda: spmv_minmax_pull(ptr, ind, val, x, sr, n,
                                                sched=sched), 200)
        plain_ms = _event_ms(lambda: spmv_minmax_pull_plain(ptr, ind, val, x,
                                                            sr, n), 20)
        old_ms = _event_ms(old_route, 20)
        dev = _device_ms(lambda: spmv_minmax_pull(ptr, ind, val, x, sr, n,
                                                  sched=sched), 50,
                         ["MinMaxFold"])
        identity = int((y == sr.identity(x.dtype).cuda()).sum())
        print(f"[S {tag}] {name} over the {orient.upper()}, x {x.dtype}: "
              f"equal to plain, a second launch and the old route (max "
              f"diff {err}); {identity} rows at the identity; kernel "
              f"{ms:.6f} ms, device (torch.profiler) {dev}, plain "
              f"{plain_ms:.6f} ms, old route (gather + scan) {old_ms:.6f} "
              f"ms ({old_ms / ms:.1f}x), torch.segment_reduce on "
              f"{lib_dtype} {lib_ms:.6f} ms, bound {bound_bytes} B -> "
              f"{bound_ms:.6f} ms at 3.35 TB/s ({100 * bound_ms / ms:.1f}% "
              "of it)")
        rows[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, library_ms=lib_ms)
    return rows


def phase_stepped_bfs(A, sources, goldens, reps: int = 10):
    """Stepped BFS, which pulls with no plan (K5, then the boundary gather
    K6), from the hub sources against the golden; then timed."""
    import numpy as np

    import graphblast_tpu_torch as gt

    desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PULLONLY, timing=0)
    bfs = gt.algorithms.bfs
    _reset_counts()
    levels = [bfs(A, int(s), desc, mode="stepped").to_numpy()
              for s in sources]
    iters = [int(v.max()) for v in levels]
    counts = _expect_launches("stepped BFS", {"orpull_csum": sum(iters),
                                              "gather_boundary": sum(iters)})
    for s, v, want in zip(sources, levels, goldens):
        if v.shape != (A.nrows,) or not np.isfinite(v).all():
            raise AssertionError(f"stepped BFS from {s}: bad levels array")
        bad = int((v != want).sum())
        if bad:
            raise AssertionError(f"stepped BFS from {s}: {bad} levels != "
                                 "golden")
    print(f"[bfs stepped] {len(sources)} sources: levels == NumPy golden; "
          f"iterations {iters}; launches {counts}")
    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(
        lambda: bfs(A, next(srcs), desc, mode="stepped"),
        len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached_edges = int(deg[levels[0] != 0].sum())
    print(f"[bfs stepped] plan-less pull rmat18: {per_s * 1e3:.6f} ms/run "
          f"median, {tail}, {len(sources) * reps} runs; "
          f"{reached_edges / per_s / 1e9:.6f} GTEPS at the median; "
          f"{iters[0]} iterations")
    return counts, per_s


def phase_mis(A, seed: int = 1, reps: int = 40):
    """MIS through the entry point: verify_mis, one S launch a round (the
    max pull) and, for the or pull, one K6 launch at the column ids and one
    at the row boundaries, no other kernel; then timed."""
    import importlib

    import numpy as np

    import graphblast_tpu_torch as gt

    mis_mod = importlib.import_module("graphblast_tpu_torch.algorithms.mis")
    _reset_counts()
    v = gt.algorithms.mis(A, seed=seed).to_numpy()
    launches = _read_counts()
    # the loop is deterministic: a second run with the same weights gives
    # the round count
    w0 = mis_mod.random_weights(A.nrows, seed, "cuda")
    v2, rounds = mis_mod._mis_fused(A, w0, max_niter=gt.DEFAULT.max_niter)
    counts = _expect_launches("MIS", {"minmax_pull": rounds,
                                      "gather_x": rounds,
                                      "gather_boundary": rounds}, launches)
    if v.shape != (A.nrows,) or not np.array_equal(v2.cpu().numpy(), v):
        raise AssertionError("MIS: bad or unrepeatable membership array")
    if not gt.algorithms.verify_mis(A, v):
        rp, ci, _ = A.host_csr()
        rows = np.repeat(np.arange(A.nrows), np.diff(rp))
        w = w0.cpu().numpy()
        ties = int(((w[rows] == w[ci]) & (rows != ci)).sum()) // 2
        raise AssertionError(f"MIS: verify_mis fails ({ties} adjacent "
                             "pairs of equal weight)")
    per_s, tail = _timed_runs(
        lambda: gt.algorithms.mis(A, seed=seed), reps)
    print(f"[mis] rmat18 seed {seed}: verify_mis holds; {rounds} rounds, "
          f"{int(v.sum())} vertices in the set; launches {counts}")
    print(f"[mis] {per_s * 1e3:.6f} ms/run median, {tail}, {reps} runs; "
          f"{per_s * 1e3 / rounds:.6f} ms a round")
    _mis_breakdown(A, w0, rounds)
    return counts, rounds, per_s


def _mis_breakdown(A, w0, rounds: int):
    """Where a MIS round's time goes: its two pulls as the round runs them
    (CUDA events, first-round inputs), the max pull's kernel S alone, and
    a torch.profiler trace of one mis() call (device busy time, idle
    share, the costliest kernels)."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.common import csc_int_arrays
    from graphblast_tpu_torch.ops.kernels.minmax_pull import spmv_minmax_pull
    from graphblast_tpu_torch.ops.spmv import spmv_pull

    ptr, ind, val, sched = csc_int_arrays(A)
    n = A.nrows
    f = (w0 > 1 << 29).to(torch.int32)
    max_ms = _event_ms(lambda: spmv_pull(
        ptr, ind, val, w0, gt.MaximumMultipliesSemiring, n, mask_dense=w0,
        sched=sched), 50)
    s_ms = _event_ms(lambda: spmv_minmax_pull(
        ptr, ind, val, w0, gt.MaximumMultipliesSemiring, n, sched=sched), 50)
    or_ms = _event_ms(lambda: spmv_pull(
        ptr, ind, val, f, gt.LogicalOrAndSemiring, n, mask_dense=w0,
        sched=sched), 50)
    print(f"[mis] a round's parts: MaximumMultiplies pull {max_ms:.6f} ms, "
          f"of which S alone {s_ms:.6f} ms ({100 * s_ms / max_ms:.1f}%); "
          f"LogicalOrAnd pull (K6, cumsum, K6) {or_ms:.6f} ms")
    table, wall_ms, why, _ = _device_profile(
        lambda: gt.algorithms.mis(A, seed=1), 1)
    if why:
        print(f"[mis] torch.profiler: device busy share not measured ({why})")
        return
    busy_ms = sum(table.values()) / 1e3
    top = sorted(table.items(), key=lambda kv: -kv[1])[:6]
    print(f"[mis] torch.profiler, one mis() call ({rounds} rounds): wall "
          f"{wall_ms:.6f} ms, device busy {busy_ms:.6f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; costliest kernels: "
          + "; ".join(f"{k[:60]} {v / 1e3:.6f} ms" for k, v in top))


def phase_gc(A, seed: int = 1, reps: int = 10):
    """Colouring through the entry point: "is" and "jp" checked and timed,
    "mis" checked once; verify_gc and the S and K6 counts (K6 by class)
    for each."""
    import importlib

    import numpy as np

    import graphblast_tpu_torch as gt

    mis_mod = importlib.import_module("graphblast_tpu_torch.algorithms.mis")
    gc_mod = importlib.import_module("graphblast_tpu_torch.algorithms.gc")
    max_niter = gt.DEFAULT.max_niter
    w0 = mis_mod.random_weights(A.nrows, seed, "cuda")
    out = {}
    colors_is = None
    # K6 launches a round at each of its two call-site classes (the or
    # pull's); one S launch a round for the max pull
    for algo, per_round in (("is", 0), ("jp", 1), ("mis", None)):
        kw = {} if algo != "jp" else {"max_colors": colors_is + 1}
        _reset_counts()
        col = gt.algorithms.gc(A, seed=seed, algo=algo, **kw).to_numpy()
        launches = _read_counts()
        if algo == "is":
            again, rounds = gc_mod._gc_is_fused(A, w0, max_niter=max_niter)
        elif algo == "jp":
            again, rounds = gc_mod._gc_jp_fused(A, w0, max_niter=max_niter,
                                                **kw)
        else:
            again, rounds = gc_mod._gc_mis(A, w0, gt.DEFAULT)
        colors = int(col.max())
        if not np.array_equal(again.cpu().numpy(), col):
            raise AssertionError(f"gc {algo}: unrepeatable colouring")
        if not gt.algorithms.verify_gc(A, col):
            raise AssertionError(f"gc {algo}: verify_gc fails")
        if per_round is None:
            # each colour's MIS, and the last, empty one, runs one S and
            # gathers once at the column ids and once at the boundaries a
            # round
            s_count = k6 = launches["minmax_pull"]
            if s_count < colors + 1:
                raise AssertionError(f"gc mis: {launches} launches for "
                                     f"{colors} colours")
        else:
            s_count, k6 = rounds, per_round * rounds
        counts = _expect_launches(
            f"gc {algo}", {"minmax_pull": s_count, "gather_x": k6,
                           "gather_boundary": k6}, launches)
        line = (f"[gc {algo}] rmat18 seed {seed}{' ' + str(kw) if kw else ''}"
                f": verify_gc holds; {colors} colours, {rounds} "
                f"{'colours' if algo == 'mis' else 'rounds'}; launches "
                f"{counts}")
        print(line)
        if algo == "is":
            colors_is = colors
        if per_round is not None:
            per_s, tail = _timed_runs(
                lambda: gt.algorithms.gc(A, seed=seed, algo=algo, **kw),
                reps)
            print(f"[gc {algo}] {per_s * 1e3:.6f} ms/run median, {tail}, "
                  f"{reps} runs; "
                  f"{per_s * 1e3 / rounds:.6f} ms a round")
            out[algo] = dict(counts=counts, rounds=rounds, per_s=per_s)
    return out


def phase_cc_plan_less(A, golden, k4_per_s: float, reps: int = 40):
    """CC with no plan (the n >= 2^24 route) on the rmat18 graph: labels
    equal to the golden, one S launch an iteration over the CSR's cached
    schedule and no other kernel; then timed."""
    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.cc import _cc_fused

    max_niter = gt.DEFAULT.max_niter
    _reset_counts()
    labels, iters = _cc_fused(A, None, max_niter=max_niter)
    counts = _expect_launches("plan-less CC", {"minmax_pull": iters})
    labels = labels.cpu().numpy()
    bad = int((labels != golden).sum())
    if bad or not gt.algorithms.verify_cc(A, labels):
        raise AssertionError(f"plan-less CC: {bad} labels != golden, or "
                             "verify_cc fails")
    per_s, tail = _timed_runs(
        lambda: _cc_fused(A, None, max_niter=max_niter), reps)
    print(f"[cc plan-less] rmat18: labels == NumPy golden, verify_cc holds; "
          f"{iters} iterations; launches {counts}")
    print(f"[cc plan-less] {per_s * 1e3:.6f} ms/run median, {tail}, "
          f"{reps} runs; phase 8's cc() over K4 "
          f"{k4_per_s * 1e3:.6f} ms/run ({per_s / k4_per_s:.2f}x)")
    return counts


def _walk_stats(L):
    """(mask edges, walked ids W, matches bound, probes P) of the walk of
    tc(L) over L, Lᵀ on the host: W = Σ over the edges (i, j) of the shorter
    of rows i and j; each walked id's search in the longer list of length
    l takes about ceil(log2(l + 1)) halvings, the last three inside one
    32-byte sector of eight ids, so P = Σ W_e · max(1, ceil(log2(l + 1)) -
    3) sector reads."""
    import numpy as np

    ptr, ind, _ = L.host_csr()
    deg = np.diff(ptr)
    rows = np.repeat(np.arange(L.nrows), deg)
    di, dj = deg[rows], deg[ind]
    walked = np.minimum(di, dj)
    longer = np.maximum(di, dj)
    halvings = np.ceil(np.log2(longer + 1.0))
    probes = walked * np.maximum(1.0, halvings - 3)
    return len(rows), int(walked.sum()), int(probes.sum())


# the walked-length classes of the class split: w <= 32, 33-128, 129-512,
# 513-2048 and more than 2048 ids
WALK_CLASSES = ((0, 32), (33, 128), (129, 512), (513, 2048), (2049, None))
H100_SMS = 132


def _edge_walk(L):
    """Per edge of L, on the host: (walked length w, probed sectors) of the
    search walk of tc(L), as `_walk_stats` counts them."""
    import numpy as np

    ptr, ind, _ = L.host_csr()
    deg = np.diff(ptr)
    rows = np.repeat(np.arange(L.nrows), deg)
    di, dj = deg[rows], deg[ind]
    walked = np.minimum(di, dj)
    halvings = np.ceil(np.log2(np.maximum(di, dj) + 1.0))
    return walked, walked * np.maximum(1.0, halvings - 3)


def _sub_mask(L, keep):
    """The CSR mask of L's edges where the host bool array `keep` holds,
    built on L's device."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt

    idx = torch.from_numpy(np.flatnonzero(keep)).to(L.device)
    ri, ci = L.row_ind[idx], L.col_ind[idx]
    ptr = torch.zeros(L.nrows + 1, dtype=torch.int64, device=L.device)
    ptr[1:] = torch.cumsum(torch.bincount(ri, minlength=L.nrows), 0)
    return gt.Matrix(L.nrows, L.ncols, int(idx.shape[0]),
                     ptr.to(torch.int32), ci.contiguous(), ri.contiguous(),
                     torch.ones(idx.shape[0], device=L.device), None, None,
                     None, None, format=gt.SparseFormat.CSRONLY)


def phase_tc_classes(L, reps: int = 20):
    """T1 over sub-masks of L that hold only the edges of one walked-length
    class (WALK_CLASSES), through spgemm_masked_count(L, L, mask, Lᵀ):
    each class's edges, walked ids, probed sectors, its T1 time (events
    and torch.profiler over the same `reps` calls, the SM clock sampled
    by nvidia-smi) and the probed sectors a clock on each SM that device
    time gives. The counts of the classes must add up to tc(L)."""
    import numpy as np

    from graphblast_tpu_torch.ops import spgemm as sp

    walked, probes = _edge_walk(L)
    total, rows = 0, []
    for lo, hi in WALK_CLASSES:
        keep = (walked >= lo) & (walked <= (hi or walked.max()))
        if not keep.any():
            continue
        M = _sub_mask(L, keep)
        fn = lambda: sp.spgemm_masked_count(L, L, M, True)  # noqa: E731
        total += fn()                    # warm: builds what it caches
        win = _window(fn, reps, ["count_kernel"])
        mhz = max((s[0] for s in win["smi"]), default=0.0)
        sectors = float(probes[keep].sum())
        clocks = (win["device_ms"] or 0.0) * 1e-3 * H100_SMS * mhz * 1e6
        rate = f"{sectors / clocks:.3f}" if clocks else "not measured"
        name = f"{lo}-{hi}" if hi else f">{lo - 1}"
        rows.append((name, win["device_ms"] or 0.0))
        print(f"[T1 class w {name}] {int(keep.sum())} edges, "
              f"{int(walked[keep].sum())} walked ids, {sectors:.6g} probed "
              f"sectors; {_window_text(win)}; {rate} sectors a clock an "
              f"SM (device time, {H100_SMS} SMs, top SM clock sampled)")
    whole = sp.spgemm_masked_count(L, L, L, True)
    if total != whole:
        raise AssertionError(f"T1 classes count {total}, tc(L) {whole}")
    dev = sum(ms for _, ms in rows)
    print("[T1 classes] share of the classes' device time: " + ", ".join(
        f"w {name} {100 * ms / dev:.2f}%" for name, ms in rows)
        + f"; counts add up to {whole}")


def main_tc_classes() -> int:
    """`--tc-classes`: the build, the rmat18 graph, L = tril(A) and the
    class split of T1 alone (phase_tc_classes), on whichever
    graphblast_tpu_torch lies beside this script."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    phase_device_and_build()
    A = rmat_matrix(18, 16, seed=42, device="cuda")
    if (A.nrows, A.nvals) != (RMAT18_N, RMAT18_NNZ):
        raise AssertionError("rmat18 differs from the recorded graph")
    t0 = time.perf_counter()
    phase_tc_classes(gt.tril(A))
    print(f"[phase] T1 class split {time.perf_counter() - t0:.2f} s")
    return 0


def _library_spgemm(L):
    """(ms or None, text) of the library route of tc(L): cuSPARSE's SpGEMM
    of L by Lᵀ (torch.sparse.mm), timed without the masked sum that would
    follow it, where it can run. With unit values its entries add up to
    the number of products, Σ_k |column k of L|², which is checked."""
    import torch

    m = L.nvals
    lc = torch.sparse_csr_tensor(L.row_ptr, L.col_ind[:m], L.val[:m],
                                 size=L.shape, check_invariants=False)
    ltc = torch.sparse_csr_tensor(L.col_ptr, L.csc_row_ind[:m],
                                  L.csc_val[:m], size=L.shape,
                                  check_invariants=False)
    products = int(((L.col_ptr[1:] - L.col_ptr[:-1]).long() ** 2).sum())
    free, _ = torch.cuda.mem_get_info()
    if products >= 1 << 31 or products * LIBRARY_BYTES_A_PRODUCT > free:
        return None, (f"not run: L·Lᵀ takes {products} products (its nnz is "
                      f"at most that), beyond 2^31 or "
                      f"{LIBRARY_BYTES_A_PRODUCT} B a product of the {free} "
                      "B free")
    prod = torch.sparse.mm(lc, ltc)
    prod_nnz, total = prod._nnz(), float(prod.values().double().sum())
    del prod
    if abs(total - products) > 1e-6 * products:
        raise AssertionError(f"tc: L·Lᵀ from torch.sparse.mm sums to "
                             f"{total}, not {products}")
    lib_ms = _event_ms(lambda: torch.sparse.mm(lc, ltc), 3)
    torch.cuda.empty_cache()
    return lib_ms, (f"{lib_ms:.6f} ms (torch.sparse.mm alone: L·Lᵀ has "
                    f"{prod_nnz} entries from {products} products)")


def phase_tc(A, reps: int = 10, golden_scale: int = 16):
    """Triangle counting at RMAT scale 18 over T1 and the masked mxm over
    T2 (ops/kernels/masked_intersect.py): L = tril(A); tc(L) warm, then
    `reps` timed calls, one T1 launch each; the count equal to its plain
    version on the card and a second launch, printed beside the JAX
    bench's record; tc equal to the host golden tc_cpu at RMAT scale
    `golden_scale`; mxm(L, L, mask L, transpose_inp1) with PlusMultiplies
    and MinimumPlus over L and over a value-perturbed copy, and PlusMinus
    with that copy as B (⊗'s operand order), each one T2 launch, held to
    the plain version (min exact; plus within 1e-5·max|c| of a float64
    plain version) and bitwise to a second launch; trace_mxm_transpose
    against its plain version. Times T1, T2, their plain versions and the
    library route (`_library_spgemm`), at rmat18 and at the golden's
    scale."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.io.rmat import rmat_matrix
    from graphblast_tpu_torch.ops import spgemm as sp
    from graphblast_tpu_torch.ops.kernels.intersect_schedule import (
        build_intersect_schedule)
    from graphblast_tpu_torch.ops.kernels.masked_intersect import (
        masked_intersect_count, masked_intersect_count_plain,
        masked_intersect_fold, masked_intersect_fold_plain)

    jax_record = 82_996_539   # BENCH_r04.json, TPU v5 lite, same graph
    t0 = time.perf_counter()
    L = gt.tril(A)
    torch.cuda.synchronize()
    print(f"[tc] L = tril(A): n={L.nrows} nnz={L.nvals}, built on the host "
          f"in {time.perf_counter() - t0:.2f} s")
    _reset_counts()
    t0 = time.perf_counter()
    ntris = gt.algorithms.tc(L)   # first: the lists' check, the schedule
    first_s = time.perf_counter() - t0
    _expect_launches("tc first", {"masked_intersect_count": 1})
    sched = L._plans["intersect/mask"][0][2]
    _expect_routes("tc first", masked_intersect_count, sched)
    ops = sp._operands(L, L, L, True)
    args = sp._count_args(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_intersect_schedule(ops[0], ops[1], ops[2], ops[5], L.ncols, False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _reset_counts()
    times, got = [], set()
    for _ in range(reps):
        t0 = time.perf_counter()
        got.add(gt.algorithms.tc(L))     # reads the total: synchronous
        times.append(time.perf_counter() - t0)
    counts = _expect_launches("tc", {"masked_intersect_count": reps})
    _expect_routes("tc", masked_intersect_count, sched, reps)
    if len(L._plans["intersect/mask"]) != 1:
        raise AssertionError("tc built its schedule more than once")
    tc_launches = counts["masked_intersect_count"]
    per_s, tail = _median_and_tail(times)
    plain = masked_intersect_count_plain(*args)
    again = masked_intersect_count(*args, sched=sched)
    if got != {ntris} or ntris != plain or again != ntris:
        raise AssertionError(f"tc: {sorted(got)} from tc(), {ntris} first, "
                             f"{plain} plain, {again} again")
    print(f"[tc] rmat18: {ntris} triangles, equal to the plain version on "
          f"the card and to a second launch; the JAX bench's record on the "
          f"same graph {jax_record:,} "
          f"({'equal' if ntris == jax_record else 'differs'})")
    print(f"[tc] {per_s * 1e3:.6f} ms/run median, {tail}, {reps} runs; "
          f"{A.nvals / per_s / 1e6:.1f} M edges/s (bench.py: A.nvals over a "
          f"tc() call); launches {counts}; the first tc() "
          f"{first_s * 1e3:.3f} ms (the lists' check and the schedule "
          f"build, which alone takes {build_s * 1e3:.3f} ms), once")
    print(f"[tc] schedule: {_route_text(sched, ops)}")
    t0 = time.perf_counter()
    A16 = rmat_matrix(golden_scale, 16, seed=42, device="cuda")
    L16 = gt.tril(A16)
    t1 = time.perf_counter()
    want16 = gt.algorithms.tc_cpu(L16)
    t2 = time.perf_counter()
    got16 = gt.algorithms.tc(L16)
    if got16 != want16:
        raise AssertionError(f"tc at rmat{golden_scale}: {got16} != host "
                             f"golden {want16}")
    tc16_ms = _event_ms(lambda: gt.algorithms.tc(L16), 10)
    lib16_ms, lib16_text = _library_spgemm(L16)
    print(f"[tc] rmat{golden_scale}: tc {got16} == host golden tc_cpu "
          f"(graph {t1 - t0:.2f} s, golden {t2 - t1:.2f} s); tc "
          f"{tc16_ms:.6f} ms a call, library {lib16_text}")
    del A16, L16

    m, walked, probes = _walk_stats(L)
    n = L.nrows
    new_wf, search_wf = _model_wavefronts(sched, ops)
    t1_bytes = 8 * m + 4 * (n + 1)            # row ids, col ids, row_ptr
    t2_bytes = t1_bytes + 4 * m + 4 * m       # values, c
    walk_bytes = 8 * m + 16 * m + 4 * walked + 32 * probes
    t1_bound = t1_bytes / HBM_BYTES_PER_S * 1e3
    t2_bound = t2_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[tc] walk: {m} mask edges, {walked} walked ids (the shorter "
          f"lists), about {probes} probed sectors by search alone; the "
          f"walk's bytes (mask, pointers, walked ids, probes) {walk_bytes} "
          f"B -> {walk_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms at 3.35 TB/s; "
          f"the schedule's cost model: {new_wf:.6g} L1 wavefronts on its "
          f"routes, {search_wf:.6g} on the search route alone")
    count = lambda: masked_intersect_count(*args, sched=sched)  # noqa: E731
    ms = _event_ms(count, 20)
    win = _window(count, 100, ["count_kernel"])
    plain_ms = _event_ms(lambda: masked_intersect_count_plain(*args), 2)

    lib_ms, lib_text = _library_spgemm(L)
    print(f"[T1] count: kernel {ms:.6f} ms (events); "
          f"{_window_text(win)}; plain {plain_ms:.6f} ms, library "
          f"{lib_text}; bound {t1_bytes} B (inputs once) -> {t1_bound:.6f} "
          f"ms at 3.35 TB/s")
    t1_row = dict(max_abs_err=abs(again - plain), ms=ms, plain_ms=plain_ms,
                  bound_ms=t1_bound, library_ms=lib_ms)

    # T2: the masked mxm, TC's general route, over L and a perturbed copy;
    # MaximumMultiplies over negated values, where its identity 0 must join
    # only where a walked id has no partner
    r, c, _ = L.extract_tuples()
    rng = np.random.default_rng(42)
    w = rng.uniform(1.0, 2.0, m).astype(np.float32)
    Lp = gt.Matrix.from_coo(r, c, w, n, n, device="cuda")
    Ln = gt.Matrix.from_coo(r, c, -w, n, n, device="cuda")
    desc = gt.Descriptor(transpose_inp1=True)
    fold_rows, fold_launches = {}, None
    cases = [("plus_times", "PlusMultiplies", L, L),
             ("min_plus", "MinimumPlus", L, L),
             ("plus_times_w", "PlusMultiplies", Lp, Lp),
             ("min_plus_w", "MinimumPlus", Lp, Lp),
             ("plus_minus", "PlusMinus", L, Lp),
             ("max_times_neg", "MaximumMultiplies", Ln, Lp)]
    for tag, name, X, Y in cases:
        sr = getattr(gt.semiring, f"{name}Semiring")
        _reset_counts()
        C = gt.mxm(X, Y, sr, mask=L, desc=desc)
        counts = _expect_launches(f"mxm {tag}", {"masked_intersect_fold": 1})
        if tag == "plus_times":
            fold_launches = counts["masked_intersect_fold"]
        ops = sp._operands(X, Y, L, True)
        fsched = sp.schedule_for(L, ops, L.ncols, True)   # mxm's, cached
        _expect_routes(f"mxm {tag}", masked_intersect_fold, fsched)
        fold = lambda: masked_intersect_fold(  # noqa: E731
            *ops, sr, sched=fsched)
        c = C.val[:m]
        c2 = fold()
        if not torch.equal(c.view(torch.int32), c2.view(torch.int32)):
            raise AssertionError(f"T2 {tag}: differs from a second launch")
        if name in ("MinimumPlus", "MaximumMultiplies"):
            want = masked_intersect_fold_plain(*ops, sr)
            err = float((c.double() - want.double()).abs().max())
            if not torch.equal(c, want):
                raise AssertionError(f"T2 {tag}: != plain (max diff {err})")
            tol_text = "equal to the plain version"
            if name == "MaximumMultiplies":
                neg, zero = int((c < 0).sum()), int((c == 0).sum())
                if not (neg and zero and neg + zero == m):
                    raise AssertionError(f"T2 {tag}: {neg} negative and "
                                         f"{zero} zero values of {m}")
                tol_text += (f" ({neg} negative: the walked list matched "
                             f"in full; {zero} the identity 0)")
        else:
            d_ops = ops[:4] + (ops[4].double(),) + ops[5:7] + (
                ops[7].double(),)
            want = masked_intersect_fold_plain(*d_ops, sr)
            err = float((c.double() - want).abs().max())
            tol = 1e-5 * float(want.abs().max())
            if not err <= tol:
                raise AssertionError(f"T2 {tag}: {err} from the float64 "
                                     f"plain version, above {tol}")
            tol_text = (f"within {err:.3g} of the float64 plain version "
                        f"(bar {tol:.3g})")
        if c.shape != (m,) or not bool(torch.isfinite(c).all()):
            raise AssertionError(f"T2 {tag}: values not finite, or of "
                                 f"shape {tuple(c.shape)}")
        fold_ms = _event_ms(fold, 20)
        line = (f"[T2 {tag}] mxm({name}, mask L, Lᵀ): one launch, bitwise "
                f"equal to a second, {tol_text}; kernel {fold_ms:.6f} ms")
        if tag == "plus_times":
            fold_plain_ms = _event_ms(
                lambda: masked_intersect_fold_plain(*ops, sr), 2)
            fold_win = _window(fold, 100, ["fold_kernel"])
            line += (f"; schedule {_route_text(fsched, ops)}; "
                     f"{_window_text(fold_win)}; plain "
                     f"{fold_plain_ms:.6f} ms, library "
                     f"{lib_text.split(' (')[0]}, bound {t2_bytes} B "
                     f"-> {t2_bound:.6f} ms at 3.35 TB/s")
            fold_rows = dict(max_abs_err=err, ms=fold_ms,
                             plain_ms=fold_plain_ms, bound_ms=t2_bound,
                             library_ms=lib_ms)
        print(line)

    _reset_counts()
    sr = gt.MaximumMultipliesSemiring
    tr = gt.trace_mxm_transpose(Ln, Lp, sr)
    _expect_launches("trace max", {"masked_intersect_fold": 1})
    _expect_routes("trace max", masked_intersect_fold,
                   Ln._plans["intersect/trace"][0][2])
    tr_plain = sp.intersect_rows_reduce_plain(Ln, Lp, sr)
    if not torch.equal(tr, tr_plain):
        raise AssertionError(f"trace max: {float(tr)} != plain "
                             f"{float(tr_plain)}")
    print(f"[tc] trace_mxm_transpose(-L', L', MaximumMultiplies) = "
          f"{float(tr)}, equal to its plain version; one T2 launch")
    del Lp, Ln

    _reset_counts()
    tr = gt.trace_mxm_transpose(A, A, gt.PlusMultipliesSemiring)
    _expect_launches("trace", {"masked_intersect_fold": 1})
    tsched = A._plans["intersect/trace"][0][2]
    _expect_routes("trace", masked_intersect_fold, tsched)
    tr_plain = sp.intersect_rows_reduce_plain(A, A,
                                              gt.PlusMultipliesSemiring)
    if float(tr) != float(tr_plain):
        raise AssertionError(f"trace: {float(tr)} != plain {float(tr_plain)}")
    print(f"[tc] trace_mxm_transpose(A, A) = {float(tr)} (nnz {A.nvals}), "
          f"equal to its plain version; one T2 launch; schedule "
          f"{_route_text(tsched, sp._diagonal_operands(A, A))}")
    phase_tc_classes(L)
    return tc_launches, fold_launches, t1_row, fold_rows, L


def _expect_routes(path: str, fn, sched, launches: int = 1) -> None:
    """Raise unless the edges fn sent down each route since
    _reset_counts() are `launches` times those of `sched`, and they add up
    to its edges."""
    want = {k: launches * v for k, v in sched.routes.items()}
    if fn.routes != want or sum(sched.routes.values()) != sched.edges:
        raise AssertionError(f"{path}: routes {fn.routes}, expected {want}")


def _route_text(sched, ops) -> str:
    """The route split of an intersection schedule over the walk `ops`:
    edges, and ids walked (the shorter lists on the search route, B's
    lists streamed on the bitmap route), on each route."""
    import torch

    mi, mj, a_ptr, _, _, b_ptr, _, _ = ops
    la = (a_ptr[mi.long() + 1] - a_ptr[mi.long()]).long()
    lb = (b_ptr[mj.long() + 1] - b_ptr[mj.long()]).long()
    on = sched.bitmap
    ids_b = int(lb[on].sum())
    ids_s = int(torch.minimum(la, lb)[~on].sum())
    r = sched.routes
    return (f"{sched.units} units, {sched.pieces} bitmap pieces; bitmap "
            f"route {r['bitmap']} edges "
            f"({100 * r['bitmap'] / max(1, sched.edges):.2f}%), {ids_b} ids "
            f"streamed; search route {r['search']} edges, {ids_s} ids "
            f"walked; bitmap {sched.words} words")


def _model_wavefronts(sched, ops):
    """(L1 wavefronts of the schedule's routes, of the search route alone)
    by the cost model of ops/kernels/intersect_schedule.py."""
    import torch

    from graphblast_tpu_torch.ops.kernels import intersect_schedule as isch

    search, bitmap_r, r, _ = isch.edge_costs(ops[0], ops[1], ops[2], ops[5])
    routed = torch.where(sched.bitmap, -(-bitmap_r // r), search)
    return ((int(routed.sum()) + isch.EDGE * sched.edges) / 8,
            (int(search.sum()) + isch.EDGE * sched.edges) / 8)


def phase_tc_past_budget(n: int = 1 << 21, m: int = 3_000_000,
                         seed: int = 21):
    """A seeded random graph made on the card whose bitmap does not fit the
    shared-memory budget (n = 2^21: 256 KB for T1): A symmetric with about
    2m edges, L its lower triangle, both CSR on the card. tc(L), the
    masked mxm over (L, L, mask L, Lᵀ) with PlusMultiplies and
    MinimumPlus, and the trace of A with MinimumPlus take the search route
    alone, one launch each, and equal their plain versions (the sums of
    ones are small integers, so exactly)."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops import spgemm as sp
    from graphblast_tpu_torch.ops.kernels.intersect_schedule import (
        SMEM_BUDGET)
    from graphblast_tpu_torch.ops.kernels.masked_intersect import (
        masked_intersect_count, masked_intersect_fold)

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    e = torch.randint(0, n, (2, m), generator=g, device="cuda")
    key = torch.unique(torch.cat([e[0] * n + e[1], e[1] * n + e[0]]))
    key = key[key // n != key % n]

    def csr(k):
        rows, cols = (k // n).to(torch.int32), (k % n).to(torch.int32)
        ptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
        ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        return gt.Matrix(n, n, k.shape[0], ptr.to(torch.int32), cols, rows,
                         torch.ones(k.shape[0], device="cuda"), None, None,
                         None, None, format=gt.SparseFormat.CSRONLY)

    A, L = csr(key), csr(key[key // n > key % n])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if n // 8 <= SMEM_BUDGET:
        raise AssertionError(f"n = {n}: its bitmap fits the budget")
    _reset_counts()
    got = gt.algorithms.tc(L)
    _expect_launches("tc past the budget", {"masked_intersect_count": 1})
    want = sp.spgemm_masked_count_plain(L, L, L, transpose_b=True)
    if got != want or masked_intersect_count.routes != {
            "bitmap": 0, "search": L.nvals}:
        raise AssertionError(f"tc past the budget: {got} != plain {want}, "
                             f"or routes {masked_intersect_count.routes}")
    for name in ("PlusMultiplies", "MinimumPlus"):
        sr = getattr(gt.semiring, f"{name}Semiring")
        _reset_counts()
        c = sp.spgemm_masked(L, L, L, sr, transpose_b=True).val
        _expect_launches(f"mxm {name} past the budget",
                         {"masked_intersect_fold": 1})
        if not torch.equal(c, sp.spgemm_masked_plain(
                L, L, L, sr, transpose_b=True).val) or \
                masked_intersect_fold.routes != {"bitmap": 0,
                                                 "search": L.nvals}:
            raise AssertionError(f"mxm {name} past the budget differs from "
                                 f"plain, or routes "
                                 f"{masked_intersect_fold.routes}")
    _reset_counts()
    sr = gt.MinimumPlusSemiring
    tr = sp.intersect_rows_reduce(A, A, sr)
    _expect_launches("trace past the budget", {"masked_intersect_fold": 1})
    if not torch.equal(tr, sp.intersect_rows_reduce_plain(A, A, sr)) or \
            masked_intersect_fold.routes != {"bitmap": 0, "search": n}:
        raise AssertionError(f"trace past the budget: {float(tr)} differs "
                             f"from plain, or routes "
                             f"{masked_intersect_fold.routes}")
    print(f"[tc past budget] random graph on the card: n={n} (bitmap "
          f"{n // 8} B > budget {SMEM_BUDGET} B), A {A.nvals} edges, L "
          f"{L.nvals}, built in {build_s:.2f} s; tc {got} == plain; mxm "
          f"PlusMultiplies and MinimumPlus, trace MinimumPlus == plain; "
          f"every edge on the search route, one launch each")


# ---------------------------------------------------------------- the push
# an SSSP push (valued Min): scatter pushes of one lane an edge over
# slices of the frontier, each 2 row-pointer gathers, the lanes' edge
# bases, the adjacency and the 2 value gathers (no fill: it scatters; no
# sparse filter: the filter is dense); a frontier past `slice_lanes` adds
# 2 degree gathers for the cut
SSSP_PUSH_K6 = 6
# a BFS push (structure-only LogicalOr) is one bitmap push, no K6
BITMAP = "bitmap_push"
# a valued BFS push (LogicalOr over the frontier's values) takes the
# workspace route, the sort push: 2 degree gathers, 5 in the expansion, 2
# value gathers, 1 fill and 1 mask gather
VALUED_BFS_PUSH_K6 = 11
# its pull has no plan: K6 at the column ids, then at the row boundaries
VALUED_BFS_PULL_K6 = {"gather_x": 1, "gather_boundary": 1}


def _count_syncs(fn):
    """(fn's result, the synchronizing CUDA operations it made, as the
    file:line that made each): each host read of a device value waits for
    the stream, and torch.cuda.set_sync_debug_mode("warn") warns at each
    such wait."""
    import warnings

    import torch

    torch.cuda.synchronize()
    # switched on outside the record: the switch may warn itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]


def _direction_trace(A, source: int, desc, algo: str):
    """Stepped replay of `algo` ("bfs" or "sssp") from `source` under desc,
    through the step the fused loop runs (BFS with its bitmap plan, SSSP
    with its monoid plan). Each iteration: its direction, the frontier's
    count and degree total, the push's route and lanes as mxv_dual's
    counters recorded them (`_counted_route`), the host reads it made (the
    loop's succ read included) and its host ms."""
    import torch

    from graphblast_tpu_torch.algorithms.bfs import (
        _bfs_step, _initial_frontier, bfs_pull_plan)
    from graphblast_tpu_torch.algorithms.common import edge_cap_for
    from graphblast_tpu_torch.ops.dispatch import _host_state
    from graphblast_tpu_torch.algorithms.sssp import (
        _initial_frontier as _sssp_initial_frontier)
    from graphblast_tpu_torch.algorithms.sssp import _sssp_step
    from graphblast_tpu_torch.ops.kernels.monoid_pull import (
        FLT_MAX, plan_for_monoid)

    n = A.nrows
    kw = dict(switchpoint=desc.switchpoint, mode=desc.mxv_mode,
              edge_cap=edge_cap_for(A, desc), sort_push=desc.sort_push)
    if algo == "bfs":
        plan = bfs_pull_plan(A, desc)
        f = _initial_frontier(n, source, A.device,
                              with_values=not desc.structure_only)
        v = torch.zeros(n + 1, device=A.device)
        ident = 0.0

        def step(v, f, it):
            return _bfs_step(A, v, f, it, plan=plan,
                             struconly=desc.structure_only, **kw)
    else:
        plan = plan_for_monoid(A, transpose=True)
        f = _sssp_initial_frontier(n, source, A.device)
        v = torch.cat([f.dense, f.dense.new_full((1,), FLT_MAX)])
        ident = FLT_MAX

        def step(v, f, it):
            return _sssp_step(A, v, f, plan, **kw)
    rows, it, succ = [], 1, 1
    while succ > 0 and it <= desc.max_niter:
        # read apart from the iteration, which reads them itself
        deg_total, nv, _ = _host_state(A.row_ptr, f, ident)

        def run():
            t0 = time.perf_counter()
            out = step(v, f, it)
            return out, int(out[2]), (time.perf_counter() - t0) * 1e3

        before = _push_counters()
        ((v, f, _, pushed), succ, ms), reads = _count_syncs(run)
        rows.append(dict(it=it, push=pushed, snvals=nv, deg_total=deg_total,
                         **(_counted_route(before, _push_counters())
                            if pushed else {}),
                         host_reads=len(reads), read_at=sorted(set(reads)),
                         ms=ms))
        it += 1
    return rows


def _push_counters() -> dict:
    """mxv_dual's five push counters as they stand."""
    from graphblast_tpu_torch.ops.dispatch import mxv_dual

    return {name: getattr(mxv_dual, name) for name in (
        "push_edges", "push_lanes", "top_tier_pushes", "bitmap_pushes",
        "sliced_pushes")}


def _counted_route(before: dict, after: dict) -> dict:
    """What mxv_dual's counters recorded of the one push between two
    readings of `_push_counters`: its route ("bitmap", "sliced" for a push
    cut into slices, "uncut" for any other: one slice or the workspace),
    its edges and lanes, and whether its lanes reached edge_cap."""
    d = {k: after[k] - before[k] for k in after}
    route = ("bitmap" if d["bitmap_pushes"] else
             "sliced" if d["sliced_pushes"] else "uncut")
    return dict(route=route, edges=d["push_edges"], lanes=d["push_lanes"],
                at_cap=bool(d["top_tier_pushes"]))


def _trace_summary(rows) -> dict:
    """Pushes, pulls, switches, the most host reads an iteration, and the
    directions as a string (P push, l pull)."""
    dirs = "".join("P" if r["push"] else "l" for r in rows)
    return dict(pushes=dirs.count("P"), pulls=dirs.count("l"),
                switches=sum(a != b for a, b in zip(dirs, dirs[1:])),
                max_reads=max(r["host_reads"] for r in rows), dirs=dirs)


def _check_reads(path: str, rows, limit: int = 2):
    """Raises if an iteration made more than `limit` host reads."""
    worst = max(rows, key=lambda r: r["host_reads"])
    if worst["host_reads"] > limit:
        raise AssertionError(
            f"{path}: iteration {worst['it']} made {worst['host_reads']} "
            f"host reads, at {worst['read_at']}; at most {limit} expected")


def _trace_text(rows) -> str:
    return "; ".join(
        f"it {r['it']}: {'push' if r['push'] else 'pull'}, frontier "
        f"{r['snvals']}, deg_total {r['deg_total']}"
        + (f", {r['route']} push of {r['lanes']} lanes"
           + (" (edge_cap)" if r["at_cap"] else "") if r["push"] else "")
        + f", host reads {r['host_reads']} ({', '.join(r['read_at'])}), "
        f"{r['ms']:.6f} ms" for r in rows)


def _expected_launches(sums, pull_kernel, push_k6) -> dict:
    """The launches of the runs the trace summaries describe: the pull
    kernel once a pull, and push_k6 K6 a push (or, for push_k6 BITMAP, one
    bitmap push)."""
    pushes = sum(x["pushes"] for x in sums)
    out = {pull_kernel: sum(x["pulls"] for x in sums)}
    if push_k6 == BITMAP:
        out[BITMAP] = pushes
    else:
        out["gather_boundary"] = push_k6 * pushes
    return out


def _push_split(A, golden_hub, reps: int = 50):
    """One BFS push iteration at the hub's level-2 frontier (vxm over the
    CSR, the visited mask complemented), by its steps, each timed alone by
    CUDA events: the expansion, the destination sort, the fill and the
    compaction (the mask gather included), in the lanes mxv_dual's
    counters give for the same push over the frontier's values (its
    workspace route); and mxv_dual whole. Returns the step ms, the
    workspace and the expansion's edge_idx (the largest gather's
    indices)."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops import spmspv
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual
    from graphblast_tpu_torch.ops.kernels.bitmap_push import (
        spmspv_push_bitmap, spmspv_push_bitmap_plain)
    from graphblast_tpu_torch.ops.gather_dispatch import take
    from graphblast_tpu_torch.ops.spmv import mask_pass

    n = A.nrows
    sr = gt.LogicalOrAndSemiring
    f = DualFrontier.from_dense(torch.from_numpy(
        (golden_hub == 2).astype("float32")).cuda(), 0.0)
    v = torch.from_numpy(((golden_hub >= 1) & (golden_hub <= 2)).astype(
        "float32")).cuda()
    # the valued push takes the workspace route: its counted edges and
    # lanes size the steps below
    before = _push_counters()
    valued = mxv_dual(A, f, sr, 0.0, transpose=True, mask_dense=v,
                      mask_scmp=True, structure_only=False,
                      mode=gt.Direction.PUSHONLY)[0]
    pushed = _counted_route(before, _push_counters())
    if pushed["route"] != "uncut":
        raise AssertionError(f"the valued push took {pushed}, not the "
                             "workspace")
    deg_total, cap = pushed["edges"], pushed["lanes"]
    fs = f.sind if pushed["at_cap"] else f.sind[:cap]
    ptr, ind = A.row_ptr, A.col_ind

    def expansion():
        return spmspv.expand_frontier(ptr, ind, None, fs, None, f.snvals,
                                      cap, True, sr, torch.float32)

    dst, mv, valid, _ = expansion()
    tgt = torch.where(valid, dst, n)

    def sort():
        return spmspv.sort_segments(tgt, mv, sr, True)

    keys, vals, heads = sort()

    def fill():
        return spmspv.fill_segments(keys, vals, heads, sr, torch.float32)

    seg_val = fill()

    def compaction():
        key_ids = keys.clamp(max=n - 1)
        keep = (heads & (keys < n) & (seg_val != 0)
                & mask_pass(take(v, key_ids, sorted=True), True))
        return spmspv.compact_heads(keys, seg_val, keep, n, 0.0, False)

    def whole():
        return mxv_dual(A, f, sr, 0.0, transpose=True, mask_dense=v,
                        mask_scmp=True, structure_only=True,
                        mode=gt.Direction.PUSHONLY)

    snv = int(f.snvals)

    def bitmap():
        return spmspv_push_bitmap(ptr, ind, f.sind, snv, deg_total, v, True,
                                  n)

    want = whole()[0]
    got = compaction()
    mine = bitmap()
    plain = spmspv_push_bitmap_plain(ptr, ind, f.sind, snv, deg_total, v,
                                     True, n)
    for name, out in (("the sort push's steps, run one by one,", got),
                      ("the valued push", (valued.dense, valued.sind)),
                      ("the bitmap push", mine),
                      ("the bitmap push's plain version", plain)):
        if not (torch.equal(out[0], want.dense)
                and torch.equal(out[1], want.sind)):
            raise AssertionError(f"{name} differ from mxv_dual")
    split = {name: _event_ms(fn, reps) for name, fn in (
        ("expansion", expansion), ("sort", sort), ("fill", fill),
        ("compaction", compaction), ("mxv_dual", whole),
        ("bitmap_push", bitmap))}
    # P's least bytes: the column ids of the frontier's edges, the mask
    # read, y and sind written
    bound_ms = 4 * (deg_total + 3 * n) / HBM_BYTES_PER_S * 1e3
    p_row = dict(ms=split["bitmap_push"], bound_ms=bound_ms,
                 plain_ms=_event_ms(lambda: spmspv_push_bitmap_plain(
                     ptr, ind, f.sind, snv, deg_total, v, True, n), 10),
                 sort_push_ms=split["expansion"] + split["sort"]
                 + split["fill"] + split["compaction"])
    edge_idx = spmspv.expand_lanes(ptr, ind.shape[0], fs, f.snvals, cap)[1]
    return split, dict(frontier=int(f.snvals), deg_total=deg_total, cap=cap,
                       new=int(want.snvals)), edge_idx, p_row


def _gather_push(A, edge_idx):
    """K6 at the push's largest gather, the adjacency ids `ind` at the
    expansion's edge_idx: torch.equal to its plain version, to a second
    launch and to torch.index_select; times and bound."""
    import torch

    from graphblast_tpu_torch.ops.kernels.gather import (gather_1d,
                                                         gather_1d_plain)

    table = A.col_ind
    m, nt = edge_idx.shape[0], table.shape[0]
    y = gather_1d(table, edge_idx, sorted=True)
    y_again = gather_1d(table, edge_idx, sorted=True)
    y_plain = gather_1d_plain(table, edge_idx)
    y_lib = torch.index_select(table, 0, edge_idx)
    torch.cuda.synchronize()
    err = float((y.double() - y_plain.double()).abs().max())
    if not torch.equal(y, y_plain):
        raise AssertionError(f"K6 at the push's gather != plain: {err}")
    if not (torch.equal(y, y_again) and torch.equal(y, y_lib)):
        raise AssertionError("K6 at the push's gather differs from a second "
                             "launch or from torch.index_select")
    bound_bytes = 4 * (2 * m + min(nt, m))
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    ms = _event_ms(lambda: gather_1d(table, edge_idx), 200)
    plain_ms = _event_ms(lambda: gather_1d_plain(table, edge_idx), 50)
    lib_ms = _event_ms(lambda: torch.index_select(table, 0, edge_idx), 200)
    print(f"[K6 push] ind ({nt} x int32) at edge_idx (m={m}, ascending): "
          f"equal to plain (max diff {err}), to a second launch and to "
          f"torch.index_select; kernel {ms:.6f} ms, plain {plain_ms:.6f} "
          f"ms, torch.index_select {lib_ms:.6f} ms, bound {bound_bytes} B "
          f"-> {bound_ms:.6f} ms at 3.35 TB/s ({100 * bound_ms / ms:.1f}% "
          "of it)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=lib_ms)


def _check_levels(path, levels, goldens, sources):
    import numpy as np

    for s, v, want in zip(sources, levels, goldens):
        if v.shape != want.shape or not np.isfinite(v).all():
            raise AssertionError(f"{path} from {s}: bad levels array")
        bad = int((v != want).sum())
        if bad:
            raise AssertionError(f"{path} from {s}: {bad} levels != golden")


def phase_push_bfs(A, sources, goldens, reps: int = 10):
    """PUSHONLY BFS at rmat18 through the entry point from the hub sources:
    levels equal to the golden, one bitmap push an iteration and no other
    kernel; ms/run and GTEPS; the stepped trace of the first source
    (degree total, route and lanes, host reads); one push iteration at the
    hub's
    level-2 frontier, the sort push split into its steps beside the bitmap
    push (P's kernels entry); K6 at the sort push's largest gather."""
    import numpy as np

    import graphblast_tpu_torch as gt

    from graphblast_tpu_torch.algorithms.common import edge_cap_for

    desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PUSHONLY)
    bfs = gt.algorithms.bfs
    _reset_counts()
    levels = [bfs(A, int(s), desc).to_numpy() for s in sources]
    iters = [int(v.max()) for v in levels]
    counts = _expect_launches("push BFS", {BITMAP: sum(iters)})
    _check_levels("push BFS", levels, goldens, sources)
    print(f"[push bfs] {len(sources)} sources: levels == NumPy golden; "
          f"iterations {iters}; launches {counts} (one bitmap push an "
          "iteration)")
    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(lambda: bfs(A, next(srcs), desc),
                              len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached_edges = int(deg[levels[0] != 0].sum())
    print(f"[push bfs] push-only rmat18: {per_s * 1e3:.6f} ms/run median, "
          f"{tail}, {len(sources) * reps} runs; "
          f"{reached_edges / per_s / 1e9:.6f} GTEPS at the median; "
          f"{iters[0]} iterations")
    print(f"[push bfs] stepped trace from {int(sources[0])} (edge_cap "
          f"{edge_cap_for(A, desc)}): "
          + _trace_text(_direction_trace(A, int(sources[0]), desc, "bfs")))
    split, at, edge_idx, p_row = _push_split(A, goldens[0])
    print(f"[push bfs] one push iteration at the hub's level-2 frontier "
          f"({at['frontier']} vertices, deg_total {at['deg_total']}, sort "
          f"push workspace {at['cap']} lanes, {at['new']} new): "
          + ", ".join(f"{k} {v:.6f} ms" for k, v in split.items())
          + " (each step alone, CUDA events; mxv_dual takes the bitmap "
          f"push); P bound {p_row['bound_ms']:.6f} ms, plain "
          f"{p_row['plain_ms']:.6f} ms, the sort push's steps "
          f"{p_row['sort_push_ms']:.6f} ms")
    return counts[BITMAP], per_s, _gather_push(A, edge_idx), p_row


@contextlib.contextmanager
def _recording_slices():
    """Yields a list that gains, for each push inside the block whose
    frontier passes `slice_lanes` and so is cut into slices, its number of
    slices."""
    from graphblast_tpu_torch.ops import dispatch

    sliced, inner = [], dispatch.slice_bounds

    def recording(ptr, sind, snvals, lanes, deg_total):
        out = inner(ptr, sind, snvals, lanes, deg_total)
        if deg_total > lanes:
            sliced.append(len(out))
        return out

    dispatch.slice_bounds = recording
    try:
        yield sliced
    finally:
        dispatch.slice_bounds = inner


def _sssp_push_k6(iters: int, sliced) -> int:
    """K6 launches of `iters` SSSP push iterations, of which those in
    `sliced` were cut into slices (their slice counts)."""
    return (SSSP_PUSH_K6 * (iters - len(sliced))
            + sum(2 + SSSP_PUSH_K6 * k for k in sliced))


def phase_push_sssp(A, sources, goldens, reps: int = 10):
    """PUSHONLY SSSP at rmat18 through the entry point from the hub
    sources: distances equal to the golden, K6 SSSP_PUSH_K6 times an
    iteration (2 + SSSP_PUSH_K6 a slice in an iteration cut into slices)
    and no K4 or other kernel; ms/run and GTEPS."""
    import numpy as np

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused
    from graphblast_tpu_torch.ops.kernels.monoid_pull import FLT_MAX

    desc = gt.DEFAULT.replace(mxv_mode=gt.Direction.PUSHONLY)
    with _recording_slices() as sliced:
        _reset_counts()
        dists = [gt.algorithms.sssp(A, int(s), desc).to_numpy()
                 for s in sources]
        counts = _read_counts()
    iters = [_sssp_fused(A, int(s), None, switchpoint=desc.switchpoint,
                         mode=desc.mxv_mode, max_niter=desc.max_niter)[1]
             for s in sources]
    counts = _expect_launches("push SSSP", {"gather_boundary": _sssp_push_k6(
        sum(iters), sliced)}, counts)
    phase_push_sssp.k6 = counts["gather_boundary"]
    for s, d, want in zip(sources, dists, goldens):
        if d.shape != (A.nrows,) or not np.isfinite(d).all():
            raise AssertionError(f"push SSSP from {s}: bad distance array")
        bad = int((d != want).sum())
        if bad:
            raise AssertionError(f"push SSSP from {s}: {bad} distances != "
                                 "golden")
    print(f"[push sssp] {len(sources)} sources: distances == NumPy golden; "
          f"iterations {iters}; pushes in slices {len(sliced)} (slices "
          f"{sliced}); launches {counts} ({SSSP_PUSH_K6} K6 an iteration, "
          f"2 + {SSSP_PUSH_K6} a slice in a push cut into slices, no K4)")
    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(
        lambda: gt.algorithms.sssp(A, next(srcs), desc),
        len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached_edges = int(deg[dists[0] < FLT_MAX].sum())
    print(f"[push sssp] push-only rmat18: {per_s * 1e3:.6f} ms/run median, "
          f"{tail}, {len(sources) * reps} runs; "
          f"{reached_edges / per_s / 1e9:.6f} GTEPS at the median; "
          f"{iters[0]} iterations")
    return per_s


def phase_push_grid(side: int = 512, reps: int = 3):
    """BFS from vertex 0 on grid_matrix(side) (diameter 2·(side − 1)),
    PUSHONLY and PULLONLY: levels equal to the golden in both, one bitmap
    push an iteration for push and one K1 launch an iteration for pull; ms/run and ms an iteration of each. Returns the two ms/run, the
    grid and its golden."""
    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.reference import bfs_cpu
    from graphblast_tpu_torch.io.rmat import grid_matrix

    t0 = time.perf_counter()
    G = grid_matrix(side, device="cuda")
    golden = bfs_cpu(G, 0)
    iters = int(golden.max())
    print(f"[grid] grid_matrix({side}): n={G.nrows} nnz={G.nvals}, built "
          f"with its golden in {time.perf_counter() - t0:.2f} s; "
          f"{iters} iterations from vertex 0")
    out = {}
    for name, mode, expected in (
            ("push", gt.Direction.PUSHONLY, {BITMAP: iters}),
            ("pull", gt.Direction.PULLONLY, {"bitmap_pull": iters})):
        desc = gt.BFS_TUNED.replace(mxv_mode=mode)
        _reset_counts()
        levels = gt.algorithms.bfs(G, 0, desc).to_numpy()
        counts = _expect_launches(f"grid BFS {name}", expected)
        _check_levels(f"grid BFS {name}", [levels], [golden], [0])
        per_s, tail = _timed_runs(lambda: gt.algorithms.bfs(G, 0, desc),
                                  reps)
        out[name] = per_s
        print(f"[grid] {name}-only: levels == golden; launches {counts}; "
              f"{per_s * 1e3:.6f} ms/run median, {tail}, {reps} runs; "
              f"{per_s * 1e3 / iters:.6f} ms an iteration")
    return out, G, golden


# ------------------------------------------------- direction optimization
def phase_pushpull_bfs(A, sources, goldens, pull_s, push_s, reps: int = 10):
    """The default bfs(A, s) (BFS_TUNED: PUSHPULL) at rmat18 from
    the hub sources: levels equal to the golden; K1 launched once a pull
    iteration and the bitmap push once a push iteration (the directions
    from a stepped replay of each source) and no other kernel; at most 2
    host reads an iteration; ms/run and GTEPS beside the pull-only (phase
    3) and push-only (phase 18) runs; the top hub's stepped trace."""
    import numpy as np

    import graphblast_tpu_torch as gt

    desc = gt.BFS_TUNED
    traces = [_direction_trace(A, int(s), desc, "bfs") for s in sources]
    sums = [_trace_summary(t) for t in traces]
    for t in traces:
        _check_reads("PUSHPULL BFS", t)
    _reset_counts()
    levels = [gt.algorithms.bfs(A, int(s)).to_numpy() for s in sources]
    counts = _expect_launches("PUSHPULL BFS", _expected_launches(
        sums, "bitmap_pull", BITMAP))
    _check_levels("PUSHPULL BFS", levels, goldens, sources)
    print(f"[pushpull bfs] {len(sources)} sources: levels == NumPy golden; "
          f"directions {[x['dirs'] for x in sums]} (P push, l pull); "
          f"launches {counts} (one K1 a pull, one bitmap push a push); "
          f"at most {max(x['max_reads'] for x in sums)} host reads an "
          "iteration")
    # the stepped mode pulls with no plan (K5, then K6 at the boundaries);
    # its directions are the fused mode's
    _reset_counts()
    stepped = [gt.algorithms.bfs(A, int(s), mode="stepped").to_numpy()
               for s in sources]
    pulls = sum(x["pulls"] for x in sums)
    stepped_counts = _expect_launches("stepped PUSHPULL BFS", {
        "orpull_csum": pulls, "gather_boundary": pulls,
        BITMAP: sum(x["pushes"] for x in sums)})
    _check_levels("stepped PUSHPULL BFS", stepped, goldens, sources)
    print(f"[pushpull bfs] stepped, {len(sources)} sources: levels == "
          f"golden; launches {stepped_counts} (K5 and K6 a pull, one "
          "bitmap push a push)")
    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(lambda: gt.algorithms.bfs(A, next(srcs)),
                              len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached_edges = int(deg[levels[0] != 0].sum())
    print(f"[pushpull bfs] default bfs rmat18: {per_s * 1e3:.6f} ms/run "
          f"median, {tail}, {len(sources) * reps} runs; "
          f"{reached_edges / per_s / 1e9:.6f} GTEPS at the median; beside "
          f"pull-only (phase 3) {pull_s * 1e3:.6f} and push-only (phase 18) "
          f"{push_s * 1e3:.6f} ms/run")
    print(f"[pushpull bfs] stepped trace from {int(sources[0])}: "
          + _trace_text(traces[0]))
    return counts, per_s


def phase_pushpull_sssp(A, sources, goldens, pull_s, push_s,
                        reps: int = 10):
    """The default sssp(A, s) (DEFAULT: PUSHPULL) at rmat18 from the
    hub sources: distances equal to the golden; K4 once a pull iteration
    (its masked entry) and K6 SSSP_PUSH_K6 times a push iteration, no
    other kernel; at most 2 host reads an iteration; ms/run beside phases
    7 and 19."""
    import numpy as np

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops.kernels.monoid_pull import FLT_MAX

    traces = [_direction_trace(A, int(s), gt.DEFAULT, "sssp")
              for s in sources]
    sums = [_trace_summary(t) for t in traces]
    for t in traces:
        _check_reads("PUSHPULL SSSP", t)
    _reset_counts()
    dists = [gt.algorithms.sssp(A, int(s)).to_numpy() for s in sources]
    expected = _expected_launches(sums, "monoid_pull", SSSP_PUSH_K6)
    expected["monoid_pull_masked"] = expected["monoid_pull"]
    counts = _expect_launches("PUSHPULL SSSP", expected)
    for s, d, want in zip(sources, dists, goldens):
        if d.shape != (A.nrows,) or not np.isfinite(d).all():
            raise AssertionError(f"PUSHPULL SSSP from {s}: bad distances")
        bad = int((d != want).sum())
        if bad:
            raise AssertionError(f"PUSHPULL SSSP from {s}: {bad} distances "
                                 "!= golden")
    print(f"[pushpull sssp] {len(sources)} sources: distances == NumPy "
          f"golden; directions {[x['dirs'] for x in sums]}; launches "
          f"{counts} (one K4 a pull, {SSSP_PUSH_K6} K6 a push); at most "
          f"{max(x['max_reads'] for x in sums)} host reads an iteration")
    srcs = iter([int(s) for s in sources] * reps)
    per_s, tail = _timed_runs(lambda: gt.algorithms.sssp(A, next(srcs)),
                              len(sources) * reps)
    deg = np.diff(A.host_csr()[0])
    reached_edges = int(deg[dists[0] < FLT_MAX].sum())
    print(f"[pushpull sssp] default sssp rmat18: {per_s * 1e3:.6f} ms/run "
          f"median, {tail}, {len(sources) * reps} runs; "
          f"{reached_edges / per_s / 1e9:.6f} GTEPS at the median; beside "
          f"pull-only (phase 7) {pull_s * 1e3:.6f} and push-only (phase 19) "
          f"{push_s * 1e3:.6f} ms/run")
    print(f"[pushpull sssp] stepped trace from {int(sources[0])}: "
          + _trace_text(traces[0]))
    return per_s


def phase_pushpull_grid(G, golden, one_way_s, reps: int = 3):
    """BFS from vertex 0 on grid_matrix(512) under BFS_TUNED: levels equal
    to the golden; the launches the stepped replay's directions give; the
    push and pull iterations, switches and host reads an iteration; ms/run
    and ms an iteration beside phase 20's push-only and pull-only."""
    import graphblast_tpu_torch as gt

    iters = int(golden.max())
    rows = _direction_trace(G, 0, gt.BFS_TUNED, "bfs")
    x = _trace_summary(rows)
    _check_reads("grid PUSHPULL", rows)
    _reset_counts()
    levels = gt.algorithms.bfs(G, 0).to_numpy()
    counts = _expect_launches("grid PUSHPULL", _expected_launches(
        [x], "bitmap_pull", BITMAP))
    _check_levels("grid PUSHPULL", [levels], [golden], [0])
    per_s, tail = _timed_runs(lambda: gt.algorithms.bfs(G, 0), reps)
    reads = [r["host_reads"] for r in rows]
    print(f"[grid pushpull] levels == golden; {x['pushes']} push and "
          f"{x['pulls']} pull iterations, {x['switches']} switches; "
          f"launches {counts}; host reads an iteration {min(reads)}-"
          f"{max(reads)} (mean {sum(reads) / len(reads):.3f}); "
          f"{per_s * 1e3:.6f} ms/run median, {tail}, {reps} runs; "
          f"{per_s * 1e3 / iters:.6f} ms an iteration; beside push-only "
          f"{one_way_s['push'] * 1e3 / iters:.6f} and pull-only "
          f"{one_way_s['pull'] * 1e3 / iters:.6f} ms an iteration "
          "(phase 20)")
    return per_s


def phase_valued_bfs(A, source: int, golden, reps: int = 5):
    """BFS over the frontier's values (BFS_TUNED with structure_only off)
    at rmat18 from the top hub, PUSHONLY and PUSHPULL through the entry
    point: levels equal to the golden; VALUED_BFS_PUSH_K6 K6 launches a
    push iteration and VALUED_BFS_PULL_K6 a pull iteration (the
    directions from a stepped replay), no other kernel; each push through
    the workspace route in lanes that hold its degree total, rounded up to
    1,024 or at edge_cap, as mxv_dual's counters recorded them; ms/run."""
    import graphblast_tpu_torch as gt

    for name, mode in (("push-only", gt.Direction.PUSHONLY),
                       ("PUSHPULL", gt.Direction.PUSHPULL)):
        desc = gt.BFS_TUNED.replace(structure_only=False, mxv_mode=mode)
        rows = _direction_trace(A, source, desc, "bfs")
        x = _trace_summary(rows)
        _check_reads(f"valued BFS {name}", rows)
        for r in rows:
            if r["push"] and (r["route"] != "uncut" or r["lanes"] < max(
                    r["edges"], r["snvals"]) or not (
                    r["at_cap"] or r["lanes"] % 1024 == 0)):
                raise AssertionError(
                    f"valued BFS {name}: iteration {r['it']} pushed "
                    f"{r['edges']} edges from {r['snvals']} vertices on "
                    f"the {r['route']} route in {r['lanes']} lanes")
        _reset_counts()
        levels = gt.algorithms.bfs(A, source, desc).to_numpy()
        counts = _expect_launches(f"valued BFS {name}", {
            "gather_boundary": VALUED_BFS_PUSH_K6 * x["pushes"]
            + VALUED_BFS_PULL_K6["gather_boundary"] * x["pulls"],
            "gather_x": VALUED_BFS_PULL_K6["gather_x"] * x["pulls"]})
        _check_levels(f"valued BFS {name}", [levels], [golden], [source])
        per_s, tail = _timed_runs(lambda: gt.algorithms.bfs(A, source, desc),
                                  reps)
        print(f"[valued bfs] {name} rmat18 from {source}: levels == golden; "
              f"directions {x['dirs']}; launches {counts} "
              f"({VALUED_BFS_PUSH_K6} K6 a push, one at the column ids and "
              "one at the row boundaries a pull); push lanes "
              f"{[r['lanes'] for r in rows if r['push']]} for degree totals "
              f"{[r['edges'] for r in rows if r['push']]}; "
              f"{per_s * 1e3:.6f} ms/run median, {tail}, {reps} runs")
        print(f"[valued bfs] {name} stepped trace: " + _trace_text(rows))


def phase_diameter(A, lo: int = 0, hi: int = 8):
    """diameter(A, lo, hi) under BFS_TUNED (PUSHPULL) at rmat18: equal to
    the largest golden eccentricity and its first source; ms a source."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.reference import bfs_cpu

    eccs = [int(bfs_cpu(A, s).max()) - 1 for s in range(lo, hi)]
    best = max(eccs)
    want = (best, lo + eccs.index(best)) if best > 0 else (0, -1)
    got = gt.diameter(A, lo, hi)     # builds the bitmap plan, if new
    t0 = time.perf_counter()
    again = gt.diameter(A, lo, hi)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if got != want or again != want:
        raise AssertionError(f"diameter over [{lo}, {hi}): {got}, {again}; "
                             f"golden {want} (eccentricities {eccs})")
    print(f"[diameter] rmat18 sources [{lo}, {hi}): {got} == golden "
          f"(eccentricities {eccs}); {ms:.6f} ms a call, "
          f"{ms / (hi - lo):.6f} ms a source")


def phase_gbfs_driver():
    """The gbfs driver as a subprocess, with run_bfs.sh's flags on
    rmat:18:16, as run_bfs.sh TEST=1's first line runs it (the golden
    check kept): exit 0, BFS: CORRECT; its output is printed back."""
    import os

    flags = ["--timing", "0", "--earlyexit", "1", "--mxvmode", "0",
             "--struconly", "1", "--niter", "5", "--opreuse", "1"]
    cmd = [sys.executable, "-m", "graphblast_tpu_torch.examples.gbfs",
           "rmat:18:16"] + flags
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=300)
    secs = time.perf_counter() - t0
    for line in run.stdout.strip().splitlines():
        print(f"[gbfs] {line}")
    if run.returncode != 0 or "BFS: CORRECT" not in run.stdout:
        raise AssertionError(f"gbfs exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    print(f"[gbfs] {' '.join(cmd[1:])}: exit 0 in {secs:.2f} s")


def phase_cc_2_24(reps: int = 5):
    """cc() on the port's grid_matrix(4096): n = 2^24, so cc takes the
    plan-less route. Labels all 0 (the grid is connected) and verify_cc,
    one S launch an iteration over the CSR's cached schedule, no K4 and no
    other kernel; the graph's build time and ms/run. Then S at CC's call
    site on this CSR (x the ids, and a seeded permutation of them) held
    torch.equal to its plain version and to a second launch."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.cc import EXACT_IDS, _cc_fused
    from graphblast_tpu_torch.io.rmat import grid_matrix
    from graphblast_tpu_torch.ops.kernels.minmax_pull import (
        spmv_minmax_pull, spmv_minmax_pull_plain)

    t0 = time.perf_counter()
    A = grid_matrix(4096, device="cuda")
    build_s = time.perf_counter() - t0
    if A.nrows < EXACT_IDS:
        raise AssertionError(f"grid of {A.nrows} vertices is below 2^24")
    _reset_counts()
    labels = gt.algorithms.cc(A).to_numpy()
    counts = _read_counts()
    _, iters = _cc_fused(A, None, max_niter=gt.DEFAULT.max_niter)
    counts = _expect_launches("CC at 2^24", {"minmax_pull": iters}, counts)
    if "csr/monoid/ones" in A._plans or "csr/schedule" not in A._plans:
        raise AssertionError("CC at 2^24 built a K4 plan, or its pull read "
                             "no cached CSR schedule")
    if labels.shape != (A.nrows,) or np.any(labels != 0):
        raise AssertionError("CC at 2^24: labels are not all 0")
    t0 = time.perf_counter()
    if not gt.algorithms.verify_cc(A, labels):
        raise AssertionError("CC at 2^24: verify_cc fails")
    verify_s = time.perf_counter() - t0
    # S at CC's call site on this CSR: n = 2^24, an x beyond the L2, and
    # only the short bins of the schedule
    sched = A._plans["csr/schedule"]
    sr = gt.MinimumSelectSecondSemiring
    val = A.val.to(torch.int32)
    g = torch.Generator(device="cuda")
    g.manual_seed(24)
    ids = torch.arange(A.nrows, dtype=torch.int32, device="cuda")
    perm = torch.randperm(A.nrows, generator=g, device="cuda").to(torch.int32)
    for name, x in (("ids", ids), ("permuted ids", perm)):
        y = spmv_minmax_pull(A.row_ptr, A.col_ind, val, x, sr, A.nrows,
                             sched=sched)
        y_again = spmv_minmax_pull(A.row_ptr, A.col_ind, val, x, sr, A.nrows,
                                   sched=sched)
        y_plain = spmv_minmax_pull_plain(A.row_ptr, A.col_ind, val, x, sr,
                                         A.nrows)
        torch.cuda.synchronize()
        if y.shape != (A.nrows,) or y.dtype != torch.int32:
            raise AssertionError(f"S at 2^24, x {name}: bad output")
        if not (torch.equal(y, y_plain) and torch.equal(y, y_again)):
            err = int((y.long() - y_plain.long()).abs().max())
            raise AssertionError(f"S at 2^24, x {name}: differs from its "
                                 f"plain version (max diff {err}) or a "
                                 "second launch")
        print(f"[cc 2^24] S (MinimumSelectSecond over the CSR, x {name}): "
              f"torch.equal to plain and to a second launch; schedule "
              f"{_schedule_text(sched)}")
    per_s, tail = _timed_runs(lambda: gt.algorithms.cc(A), reps)
    print(f"[cc 2^24] grid_matrix(4096): n={A.nrows} nnz={A.nvals}, built "
          f"in {build_s:.2f} s; labels all 0, verify_cc holds "
          f"({verify_s:.2f} s); {iters} iterations; launches {counts}")
    print(f"[cc 2^24] {per_s * 1e3:.6f} ms/run median, {tail}, {reps} "
          f"runs; {A.nvals * iters / per_s / 1e9:.6f} cc_gteps (nvals x "
          "iterations / median)")
    return counts


# ------------------------------------------ the operations surface and LGC
def _cpu_copy(A):
    """A's tensors on the CPU, as a fresh Matrix: the same call on it runs
    every kernel's plain version."""
    import dataclasses

    import graphblast_tpu_torch as gt

    moved = {k: None if getattr(A, k) is None else getattr(A, k).cpu()
             for k in gt.matrix.LEAVES}
    return dataclasses.replace(A, **moved, _plans={})


def _site_row(tag: str, fn, plain, bound_bytes: int, library=None,
              reps: int = 200, rel_tol=None) -> dict:
    """One kernel at one call site: its output torch.equal (NaN where NaN)
    to its plain version's, or with `rel_tol` within rel_tol · max|plain|
    of it (the value pull's fp32 sums beside its float64 plain version),
    and torch.equal to a second launch's; kernel, plain and library times
    by CUDA events; the bound. The row of the kernels line."""
    import torch

    y, y_again, y_plain = fn(), fn(), plain()
    torch.cuda.synchronize()
    err = float((y.double() - y_plain.double()).abs().nan_to_num().max())
    close = (_same(y, y_plain) if rel_tol is None
             else err <= rel_tol * float(y_plain.abs().max()))
    if not (close and _same(y, y_again)):
        raise AssertionError(f"{tag}: differs from its plain version (max "
                             f"diff {err}) or a second launch")
    ms = _event_ms(fn, reps)
    plain_ms = _event_ms(plain, 10)
    lib_ms = None if library is None else _event_ms(library, 50)
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    lib = "none" if lib_ms is None else f"{lib_ms:.6f} ms"
    held = ("equal to" if rel_tol is None
            else f"within {rel_tol}·max|y| of")
    print(f"[{tag}] {held} plain (max diff {err}) and equal to a second "
          f"launch; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, library "
          f"{lib}, bound {bound_bytes} B -> {bound_ms:.6f} ms at 3.35 TB/s "
          f"({100 * bound_ms / ms:.1f}% of it)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=lib_ms)


# launches of one mxv (pull, dense u) by semiring, and of the push of a
# sparse u under MinimumPlus: the expansion's 6 gathers, the adjacency and
# two value gathers, and the Min fill, all at ascending indices
MXV_LAUNCHES = {
    "LogicalOrAnd": {"orpull_csum": 1, "gather_boundary": 1},
    "MinimumPlus": {"minmax_pull": 1},
    "PlusMultiplies": {"gather_x": 1, "gather_boundary": 1},
    "push": {"gather_boundary": 10},
}


def _api_golden(A, name, u, mask, w):
    """w + (A ⊕.⊗ u where mask == 0, else ⊕'s identity), float64 from
    scipy (Plus), float32 from NumPy (min and or), on the host."""
    import numpy as np
    import scipy.sparse as sp

    ptr, ind, val = A.host_csr()
    n = A.nrows
    if name == "PlusMultiplies":
        S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=A.shape)
        t = S @ u.astype(np.float64)
        t = np.where(mask == 0, t, 0.0)
        return w.astype(np.float64) + t
    if name == "LogicalOrAnd":
        S = sp.csr_matrix((np.ones(len(ind)), ind, ptr), shape=A.shape)
        t = ((S @ (u != 0).astype(np.float64)) > 0).astype(np.float32)
        return w + np.where(mask == 0, t, np.float32(0))
    t = _row_min(ptr, val.astype(np.float32) + u[ind], n)
    return w + np.where(mask == 0, t, MAXF32)


def _row_min(ptr, edge_vals, n):
    """The min of each CSR row's edge values (rows of a 2-D array), FLT_MAX
    on empty rows, in the values' float32: one reduceat over the
    nonempty rows."""
    import numpy as np

    out = np.full((n,) + edge_vals.shape[1:], MAXF32, np.float32)
    nonempty = np.diff(ptr) > 0
    if nonempty.any():
        out[nonempty] = np.minimum.reduceat(edge_vals, ptr[:-1][nonempty],
                                            axis=0)
    return out


def phase_api(A, reps: int = 20):
    """The operations surface at rmat18 (phase 29): mxv and vxm on a seeded
    dense u under LogicalOrAnd (structure only: K5 and K6), MinimumPlus
    (S) and PlusMultiplies (K6, then the segment reduce), each with a
    complemented mask, a Plus accumulator and w; then a sparse u of 1,000
    seeded ids under MinimumPlus, which pushes (K6). Each equal to the
    golden (exact for min and or, 1e-5·max|y| for plus) and to the same
    call on a CPU copy (the plain kernels), with its launches; ms a call.
    Then K5 and S at their mxv call sites. Returns (launches by call site,
    K5's row, S's row)."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops.kernels.bitmap_pull import pack_bitmap
    from graphblast_tpu_torch.ops.kernels.minmax_pull import (
        spmv_minmax_pull, spmv_minmax_pull_plain)
    from graphblast_tpu_torch.ops.kernels.orpull import (
        orpull_bit_csum, orpull_bit_csum_plain)
    from graphblast_tpu_torch.ops.kernels.row_schedule import schedule_for

    n = A.nrows
    rng = np.random.default_rng(29)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    w = rng.integers(0, 4, n).astype(np.float32)
    inputs = {
        "LogicalOrAnd": (rng.random(n) < 0.2).astype(np.float32),
        "MinimumPlus": np.where(rng.random(n) < 0.4, MAXF32, rng.uniform(
            0, 5, n)).astype(np.float32),
        "PlusMultiplies": rng.standard_normal(n).astype(np.float32),
    }
    ids = np.sort(rng.choice(n, 1000, replace=False))
    A_cpu = _cpu_copy(A)
    counts = {}
    cases = [(name, fn) for name in inputs for fn in ("mxv", "vxm")]
    cases += [("push", "mxv"), ("push", "vxm")]
    for name, fn in cases:
        sr_name = "MinimumPlus" if name == "push" else name
        sr = getattr(gt, sr_name + "Semiring")
        desc = gt.Descriptor(mask_scmp=True,
                             structure_only=name == "LogicalOrAnd")
        u_np = inputs[sr_name]
        if name == "push":
            u_np = np.full(n, MAXF32, np.float32)
            u_np[ids] = inputs["MinimumPlus"][ids]

        def call(M, dev):
            u = gt.Vector.dense_from(u_np, device=dev)
            if name == "push":
                u = gt.Vector.sparse_from(n, ids, u_np[ids], device=dev)
            args = (M, u) if fn == "mxv" else (u, M)
            return getattr(gt, fn)(*args, sr, mask=gt.Vector.dense_from(
                mask, device=dev), accum=gt.PlusMonoid, desc=desc,
                w=gt.Vector.dense_from(w, device=dev))

        call(A, "cuda")          # builds the schedule S reads, if new
        torch.cuda.synchronize()
        _reset_counts()
        out = call(A, "cuda")
        torch.cuda.synchronize()
        got_counts = _expect_launches(f"{fn} {name}", MXV_LAUNCHES[name])
        for k, v in got_counts.items():
            counts[k] = counts.get(k, 0) + v
        ident = MAXF32 if sr_name == "MinimumPlus" else 0.0
        if out.storage != (gt.Storage.SPARSE if name == "push"
                           else gt.Storage.DENSE):
            raise AssertionError(f"{fn} {name}: storage {out.storage}")
        y = out.to_numpy(ident)
        y_plain = call(A_cpu, "cpu").to_numpy(ident)
        want = _api_golden(A, sr_name, u_np, mask, w)
        if y.shape != (n,) or y.dtype != np.float32:
            raise AssertionError(f"{fn} {name}: bad output")
        if sr_name == "PlusMultiplies":
            tol = 1e-5 * float(np.abs(want).max())
            err = float(np.abs(y - want).max())
            err_plain = float(np.abs(y - y_plain).max())
            if err > tol or err_plain > tol:
                raise AssertionError(f"{fn} {name}: {err} from the golden, "
                                     f"{err_plain} from the plain kernels; "
                                     f"tolerance {tol}")
            check = (f"within {err} of the scipy golden and {err_plain} of "
                     f"the plain kernels (tolerance 1e-5·max|y| = {tol})")
        else:
            if not (np.array_equal(y, want) and np.array_equal(y, y_plain)):
                raise AssertionError(f"{fn} {name}: differs from the golden "
                                     "or from the plain kernels")
            check = "equal to the golden and to the plain kernels"
        per_s, tail = _timed_runs(lambda: call(A, "cuda"), reps)
        push = " (sparse u, push)" if name == "push" else ""
        print(f"[api] {fn} {sr_name}{push}, complemented mask, Plus "
              f"accumulator: {check}; launches "
              f"{got_counts}; {per_s * 1e3:.6f} ms a call median, {tail}, "
              f"{reps} calls")
    # K5 and S at their mxv call sites (the CSR's pull)
    words = pack_bitmap(torch.from_numpy(inputs["LogicalOrAnd"]).cuda())
    col = A.col_ind
    m = col.shape[0]
    k5 = _site_row("K5 at mxv", lambda: orpull_bit_csum(words, col),
                   lambda: orpull_bit_csum_plain(words, col),
                   4 * (2 * m + words.shape[0]))
    x = torch.from_numpy(inputs["MinimumPlus"]).cuda()
    sched = schedule_for(A, False)
    sr = gt.MinimumPlusSemiring
    nnz = A.nvals
    offsets = A.row_ptr.long()
    prod = (A.val[:nnz] + x[A.col_ind[:nnz].long()]).contiguous()
    s_row = _site_row(
        "S at mxv MinimumPlus",
        lambda: spmv_minmax_pull(A.row_ptr, A.col_ind, A.val, x, sr, n,
                                 sched=sched),
        lambda: spmv_minmax_pull_plain(A.row_ptr, A.col_ind, A.val, x, sr,
                                       n),
        8 * nnz + 4 * (n + 1) + 4 * n + 4 * n,
        library=lambda: torch.segment_reduce(prod, "min", offsets=offsets,
                                             initial=MAXF32))
    _row_reduce_times(A)
    return counts, k5, s_row


def _row_reduce_times(A, reps: int = 50):
    """reduce_matrix_to_vector at rmat18 under Plus, Min and Max, on A's CSR
    with seeded uniform(-1, 1) float32 values: one K6 launch a call (the
    row boundaries of Plus's float64 prefix sum, the segment tails of
    Min's and Max's scan); Min and Max equal to a scatter_reduce into the
    rows, Plus within 1e-5·max|y| of it in float64; ms beside that
    scatter_reduce in float32 (a yardstick the package never calls)."""
    import dataclasses

    import numpy as np
    import torch

    import graphblast_tpu_torch as gt

    n, m = A.nrows, A.nvals
    vals = torch.from_numpy(np.random.default_rng(292).uniform(
        -1, 1, A.nnz_pad).astype(np.float32)).cuda()
    R = dataclasses.replace(A, val=vals, col_ptr=None, csc_row_ind=None,
                            csc_col_ind=None, csc_val=None,
                            format=gt.SparseFormat.CSRONLY, symmetric=False,
                            _host_csr=None, _host_csc=None, _plans={})
    rows = A.row_ind[:m].long()

    def scatter(how, dtype=torch.float32):
        ident = {"sum": 0.0, "amin": MAXF32, "amax": 0.0}[how]
        out = torch.full((n,), ident, dtype=dtype, device="cuda")
        return out.scatter_reduce(0, rows, vals[:m].to(dtype), how,
                                  include_self=False)

    for name, how in (("Plus", "sum"), ("Minimum", "amin"),
                      ("Maximum", "amax")):
        monoid = getattr(gt, name + "Monoid")
        _reset_counts()
        y = gt.reduce_matrix_to_vector(R, monoid).dense
        torch.cuda.synchronize()
        counts = _expect_launches(f"row reduce {name}",
                                  {"gather_boundary": 1})
        if name == "Plus":
            want = scatter(how, torch.float64)
            err = float((y.double() - want).abs().max())
            tol = 1e-5 * float(want.abs().max())
            if err > tol:
                raise AssertionError(f"row reduce Plus: {err} from the "
                                     f"float64 sum, tolerance {tol}")
            check = f"within {err} of the float64 sum (tolerance {tol})"
        else:
            if not torch.equal(y, scatter(how)):
                raise AssertionError(f"row reduce {name}: differs from "
                                     "scatter_reduce")
            check = "equal to scatter_reduce"
        ms = _event_ms(lambda: gt.reduce_matrix_to_vector(R, monoid), reps)
        lib_ms = _event_ms(lambda: scatter(how), reps)
        print(f"[api] reduce_matrix_to_vector {name} at rmat18 ({m} "
              f"values): {check}; launches {counts}; {ms:.6f} ms a call "
              f"(CUDA events, {reps} calls); scatter_reduce {how} "
              f"{lib_ms:.6f} ms")


def phase_lgc(A, hub: int, reps: int = 5):
    """LGC at rmat18 (phase 30) from the top hub and from the first vertex
    of least nonzero degree, α 0.15, ε 1e-6: p within rtol 1e-3 / atol
    1e-7 of the port's lgc_cpu and with mass on more than the source, K6
    once
    an iteration at the column ids and once at the row boundaries, and
    once more for the degrees, and no other kernel; iterations and
    ms/run. Then K6 at LGC's gather of x at the column ids. Returns
    (launches of the two runs, K6's row, the hub's lgc_cpu golden)."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.lgc import _lgc_loop
    from graphblast_tpu_torch.algorithms.reference import lgc_cpu
    from graphblast_tpu_torch.ops.kernels.gather import (gather_1d,
                                                         gather_1d_plain)

    alpha, eps = 0.15, 1e-6
    total, goldens = {}, {}
    deg = np.diff(A.host_csr()[0])
    leaf = int(np.flatnonzero(deg == deg[deg > 0].min())[0])
    for name, s in (("hub", hub), (f"a degree-{deg[leaf]} vertex", leaf)):
        t0 = time.perf_counter()
        want = goldens[s] = lgc_cpu(A, s, alpha, eps, gt.DEFAULT.max_niter)
        cpu_s = time.perf_counter() - t0
        _reset_counts()
        p = gt.lgc(A, s, alpha=alpha, eps=eps).to_numpy()
        counts = _read_counts()
        _, _, iters = _lgc_loop(A, s, alpha=alpha, eps=eps,
                                max_niter=gt.DEFAULT.max_niter)
        counts = _expect_launches(f"lgc from {name}", {
            "gather_x": iters, "gather_boundary": iters + 1}, counts)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if (p.shape != want.shape or not np.isfinite(p).all()
                or (p > 0).sum() < 2):
            raise AssertionError(f"lgc from {name}: bad output")
        if not np.allclose(p, want, rtol=1e-3, atol=1e-7):
            bad = int((~np.isclose(p, want, rtol=1e-3, atol=1e-7)).sum())
            raise AssertionError(f"lgc from {name}: {bad} values past rtol "
                                 "1e-3 / atol 1e-7 of lgc_cpu")
        per_s, tail = _timed_runs(lambda: gt.lgc(A, s, alpha=alpha,
                                                 eps=eps), reps)
        print(f"[lgc] rmat18 from {name} ({s}): within rtol 1e-3 / atol "
              f"1e-7 of lgc_cpu (max diff {float(np.abs(p - want).max())}, "
              f"sum p {float(p.sum()):.6f}, {int((p > 0).sum())} vertices "
              f"with mass); {iters} iterations, launches {counts} (K6 once "
              f"an iteration at the column ids); {per_s * 1e3:.6f} ms/run "
              f"median, {tail}, {reps} runs; lgc_cpu {cpu_s:.2f} s")
    r2 = torch.from_numpy(np.random.default_rng(30).random(A.nrows).astype(
        np.float32)).cuda()
    col = A.col_ind
    m = col.shape[0]
    row = _site_row("K6 at LGC's pull (x at the column ids)",
                    lambda: gather_1d(r2, col), lambda: gather_1d_plain(
                        r2, col), 4 * (2 * m + min(A.nrows, m)),
                    library=lambda: torch.index_select(r2, 0, col))
    return total, row, goldens[hub]


def phase_glgc_driver():
    """The glgc driver as a subprocess on rmat:18:16 (phase 30): exit 0
    and LGC: CORRECT; its output printed back."""
    import os

    cmd = [sys.executable, "-m", "graphblast_tpu_torch.examples.glgc",
           "rmat:18:16"]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=300)
    secs = time.perf_counter() - t0
    for line in run.stdout.strip().splitlines():
        print(f"[glgc] {line}")
    if run.returncode != 0 or "LGC: CORRECT" not in run.stdout:
        raise AssertionError(f"glgc exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    print(f"[glgc] {' '.join(cmd[1:])}: exit 0 in {secs:.2f} s")


def phase_spgemm(reps: int = 3):
    """The unmasked SpGEMM (phase 31): C = A·A by ESC under PlusMultiplies
    and MinimumPlus on grid_matrix(512) (one chunk) and RMAT scale 14
    (chunks of 2^23 products, merged), each with seeded symmetric integer
    weights in 1..8 (`_weighted`). C's pointers and ids equal to scipy's
    A·A; its PlusMultiplies values within 1e-5 relative of scipy's float64
    sums (they are exact: every sum is an integer below 2^24), its
    MinimumPlus values equal to `_min_plus_golden`; 10 K6 launches a chunk
    and no other kernel; chunks, products,
    host reads (torch.cuda.set_sync_debug_mode), ms a call, and
    torch.sparse.mm of A by A (a yardstick only). Then K6 at the ESC's
    largest gather. Returns (launches, K6's row)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.io.rmat import grid_matrix, rmat_matrix
    from graphblast_tpu_torch.ops.kernels.gather import (gather_1d,
                                                         gather_1d_plain)
    from graphblast_tpu_torch.ops.spgemm import esc_plan, spgemm_esc
    from graphblast_tpu_torch.ops.spmspv import expand_lanes

    total = {}
    row = None
    for gname, make in (("grid_matrix(512)", lambda: grid_matrix(
            512, device="cuda")), ("rmat14", lambda: rmat_matrix(
                14, 16, seed=42, device="cuda"))):
        t0 = time.perf_counter()
        A = _weighted(make(), seed=31)
        S = A.to_scipy().astype(np.float64)
        want = S @ S
        want.sort_indices()
        want_min = _min_plus_golden(S)
        golden_s = time.perf_counter() - t0
        csum, bounds = esc_plan(A, A)
        chunks, products = len(bounds) - 1, int(csum[-1])
        print(f"[spgemm] {gname}: n={A.nrows} nnz={A.nvals}, top degree "
              f"{int(np.diff(A.host_csr()[0]).max())}, {products} products "
              f"in {chunks} chunks; scipy A·A has {want.nnz} entries "
              f"(graph and golden {golden_s:.2f} s)")
        for sr_name in ("PlusMultiplies", "MinimumPlus"):
            sr = getattr(gt, sr_name + "Semiring")
            spgemm_esc(A, A, sr)          # warm
            torch.cuda.synchronize()
            _reset_counts()
            C, syncs = _count_syncs(lambda: gt.mxm(A, A, sr))
            counts = _expect_launches(f"ESC {sr_name} {gname}",
                                      {"gather_boundary": 10 * chunks})
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            ptr, ind, val = C.host_csr()
            if not (C.shape == A.shape and np.array_equal(ptr, want.indptr)
                    and np.array_equal(ind, want.indices)):
                raise AssertionError(f"ESC {sr_name} on {gname}: C's "
                                     "structure differs from scipy's A·A")
            if sr_name == "PlusMultiplies":
                rel = float((np.abs(val - want.data) / want.data).max())
                if rel > 1e-5:
                    raise AssertionError(f"ESC Plus on {gname}: {rel} "
                                         "relative from scipy's A·A")
                check = f"values within {rel} relative of scipy's"
            else:
                if not (np.array_equal(want_min[0], want.indptr)
                        and np.array_equal(want_min[1], want.indices)
                        and np.array_equal(val, want_min[2])):
                    raise AssertionError(f"ESC Min on {gname}: differs "
                                         "from the min-plus golden")
                check = "values equal to the min-plus golden"
            per_s, tail = _timed_runs(lambda: gt.mxm(A, A, sr), reps)
            expected_reads = 2 + chunks + int(chunks > 1) + 1
            sites = sorted(set(syncs), key=syncs.index)
            print(f"[spgemm] {gname} {sr_name}: C ({C.nvals} entries, "
                  f"symmetric {C.symmetric}) structure equal to scipy's, "
                  f"{check}; launches "
                  f"{counts}; {len(syncs)} host reads (expected "
                  f"{expected_reads}: 2 sizing, {chunks} chunk counts, "
                  f"{int(chunks > 1)} merge count, 1 symmetry test) at "
                  f"{sites}; {per_s * 1e3:.6f} ms a call median, {tail}, "
                  f"{reps} calls")
        m = A.nvals
        lc = torch.sparse_csr_tensor(A.row_ptr, A.col_ind[:m], A.val[:m],
                                     size=A.shape, check_invariants=False)
        prod = torch.sparse.mm(lc, lc)
        if prod._nnz() != want.nnz:
            raise AssertionError(f"torch.sparse.mm on {gname}: "
                                 f"{prod._nnz()} entries")
        del prod
        lib_ms = _event_ms(lambda: torch.sparse.mm(lc, lc), reps)
        print(f"[spgemm] {gname}: torch.sparse.mm(A, A) (cuSPARSE, a "
              f"yardstick the package never calls) {lib_ms:.6f} ms")
        if gname == "rmat14":
            _esc_split(A, csum, bounds)
            # K6 at the ESC's largest gather: B's ids at the first chunk's
            # edge ids
            s, t = bounds[0], bounds[1]
            lanes = int(csum[t] - csum[s])
            _, b_idx, _ = expand_lanes(A.row_ptr, A.col_ind.shape[0],
                                       A.csc_col_ind[s:t], t - s, lanes)
            table = A.col_ind
            row = _site_row(
                "K6 at the ESC's gather of B's ids",
                lambda: gather_1d(table, b_idx, sorted=True),
                lambda: gather_1d_plain(table, b_idx),
                4 * (2 * lanes + min(table.shape[0], lanes)),
                library=lambda: torch.index_select(table, 0, b_idx))
        del A, S, want
        torch.cuda.empty_cache()
    return total, row


def _weighted(A, seed: int):
    """A symmetric A on the card again, with seeded integer weights in 1..8,
    one draw for each pair {i, j}, so that the result is symmetric too."""
    import numpy as np

    import graphblast_tpu_torch as gt

    ptr, ind, _ = A.host_csr()
    n = A.nrows
    r = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    c = ind.astype(np.int64)
    _, pair = np.unique(np.minimum(r, c) * n + np.maximum(r, c),
                        return_inverse=True)
    w = np.random.default_rng(seed).integers(1, 9, pair.max() + 1)[pair]
    W = gt.Matrix.from_coo(r, c, w.astype(np.float32), n, n, device="cuda")
    if not W.symmetric:
        raise AssertionError("weighted copy is not symmetric")
    return W


def _min_plus_golden(S):
    """S ⊕.⊗ S under MinimumPlus as sorted CSR (pointers, ids, float32
    values), for integer weights w ≥ 1, from one float64 scipy product: with B = 2^30 each entry of E·E, E = B^-S, is
    Σ_k B^-(s_ik + s_kj), which lies in [B^-m, (deg + 1)·B^-m) for the
    least exponent m; deg + 1 ≤ 2^12 = B^0.4 makes
    m = floor(-log_B(sum) + 0.5) exact."""
    import numpy as np

    deg = int(np.diff(S.indptr).max())
    if deg + 1 > 1 << 12:
        raise AssertionError(f"min-plus golden needs degree < 4095, not "
                             f"{deg}")
    E = S.copy()
    E.data = np.exp2(-30.0 * S.data)
    P = E @ E
    P.sort_indices()
    return P.indptr, P.indices, np.floor(-np.log2(P.data) / 30 + 0.5).astype(
        np.float32)


def _esc_split(A, csum, bounds, reps: int = 5):
    """One ESC chunk of A·A under PlusMultiplies (the first of rmat14's),
    split by CUDA events into the expansion (the lane expansion and the
    gathers, `_esc_chunk`'s first half), the stable sort by (i, j), the
    segmented ⊕ scan, and the whole dedup (`_sort_dedup_coo`: sort, scan,
    compaction), beside the whole chunk; and the cross-chunk merge."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops import spgemm as esc
    from graphblast_tpu_torch.ops.segops import segmented_scan
    from graphblast_tpu_torch.ops.gather_dispatch import take
    from graphblast_tpu_torch.ops.spmspv import expand_lanes
    from graphblast_tpu_torch.types import round_up

    sr = gt.PlusMultipliesSemiring
    s, t = bounds[0], bounds[1]
    lanes = max(round_up(int(csum[t] - csum[s]), 1024), 1024)
    ai, ak, av = A.csc_row_ind[s:t], A.csc_col_ind[s:t], A.csc_val[s:t]

    def expand():
        src, b_idx, total = expand_lanes(A.row_ptr, A.col_ind.shape[0], ak,
                                         t - s, lanes)
        j = take(A.col_ind, b_idx, sorted=True)
        prod = sr.mul(take(av, src, sorted=True),
                      take(A.val, b_idx, sorted=True))
        live = torch.arange(lanes, dtype=torch.int32, device=A.device) < total
        i = torch.where(live, take(ai, src, sorted=True), esc.ROW_SENTINEL)
        return i, j, prod

    i, j, prod = expand()
    keys = i.long() * A.ncols + j.long()
    perm = torch.sort(keys, stable=True).indices
    k_s = keys[perm]
    heads = torch.cat([torch.ones(1, dtype=torch.bool, device=A.device),
                       k_s[1:] != k_s[:-1]])
    v_s = prod[perm]
    ms = {
        "chunk": _event_ms(lambda: esc._esc_chunk(
            ai, ak, av, A.row_ptr, A.col_ind, A.val, lanes, sr, True,
            A.ncols), reps),
        "expansion": _event_ms(expand, reps),
        "dedup": _event_ms(lambda: esc._sort_dedup_coo(
            i, j, prod, sr.add, A.ncols), reps),
        "sort": _event_ms(lambda: torch.sort(keys, stable=True), reps),
        "scan": _event_ms(lambda: segmented_scan(v_s, heads, sr.add), reps),
    }
    print(f"[spgemm split] rmat14 chunk 0 of {len(bounds) - 1} "
          f"({lanes} lanes), PlusMultiplies, ms alone (CUDA events): "
          + ", ".join(f"{k} {v:.6f}" for k, v in ms.items())
          + f"; dedup {100 * ms['dedup'] / ms['chunk']:.1f}% of the chunk "
          f"(sort {100 * ms['sort'] / ms['chunk']:.1f}%, scan "
          f"{100 * ms['scan'] / ms['chunk']:.1f}%)")


def phase_mxm_dense(A, k: int = 32, reps: int = 10):
    """mxm_dense of rmat18's A by a seeded n × 32 float32 B (phase 32),
    under PlusMultiplies, against scipy's A·B in float64 within
    1e-5·max|C|, and under MinimumPlus, exactly equal to a NumPy golden;
    ms beside torch.sparse.mm (cuSPARSE's SpMM)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import graphblast_tpu_torch as gt

    n = A.nrows
    B_np = np.random.default_rng(32).standard_normal((n, k)).astype(
        np.float32)
    B = torch.from_numpy(B_np).cuda()
    ptr, ind, val = A.host_csr()
    S = sp.csr_matrix((val.astype(np.float64), ind, ptr), shape=A.shape)
    m = A.nvals
    lc = torch.sparse_csr_tensor(A.row_ptr, A.col_ind[:m], A.val[:m],
                                 size=A.shape, check_invariants=False)
    lib_ms = _event_ms(lambda: torch.sparse.mm(lc, B), reps)
    for sr_name in ("PlusMultiplies", "MinimumPlus"):
        sr = getattr(gt, sr_name + "Semiring")
        C = gt.mxm_dense(A, B, sr)
        torch.cuda.synchronize()
        got = C.cpu().numpy()
        if got.shape != (n, k) or not np.isfinite(got).all():
            raise AssertionError(f"mxm_dense {sr_name}: bad output")
        if sr_name == "PlusMultiplies":
            want = S @ B_np.astype(np.float64)
            tol = 1e-5 * float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            if err > tol:
                raise AssertionError(f"mxm_dense Plus: {err} from scipy, "
                                     f"tolerance {tol}")
            check = (f"within {err} of scipy's A·B (tolerance 1e-5·max|C| "
                     f"= {tol:.6f})")
        else:
            want = _row_min(ptr, val[:, None].astype(np.float32)
                            + B_np[ind], n)
            if not np.array_equal(got, want):
                raise AssertionError("mxm_dense Min: differs from the "
                                     "golden")
            check = "equal to the NumPy golden"
        per_s, tail = _timed_runs(lambda: gt.mxm_dense(A, B, sr), reps)
        print(f"[mxm_dense] rmat18 × B ({n} × {k} float32) {sr_name}: "
              f"{check}; {per_s * 1e3:.6f} ms a call median, {tail}, "
              f"{reps} calls; torch.sparse.mm(A, B) {lib_ms:.6f} ms")


# the six drivers of phase 33, each with its run_*.sh flags (run_cc.sh's for
# gmis, which has no script), and the line that shows it verified; gpr and
# gtc skip the golden, as their run_*.sh TEST=1 lines do
DRIVER_RUNS = (
    ("gpr", ["--timing", "0", "--mxvmode", "0", "--niter", "5",
             "--max_niter", "10", "--skip_cpu_verify"], None),
    ("gcc", ["--mxvmode", "0", "--timing", "0", "--directed", "2",
             "--niter", "5"], "CC: CORRECT"),
    ("gmis", ["--mxvmode", "0", "--timing", "0", "--directed", "2",
              "--niter", "5"], "MIS: CORRECT"),
    ("ggc", ["--niter", "10", "--mxvmode", "0", "--timing", "1",
             "--directed", "2"], "GC[CORRECT]: colors="),
    ("ggc_cusparse", ["--niter", "10", "--mxvmode", "0", "--timing", "1",
                      "--directed", "2"], "GC[CORRECT]: colors="),
    ("gtc", ["--timing", "1", "--mxvmode", "0", "--directed", "2",
             "--niter", "1", "--skip_cpu_verify"], None),
)


def phase_drivers():
    """The six other drivers as subprocesses on rmat:18:16, all
    started at once: each exits 0 and prints its timing row, and the four
    that keep the golden print their CORRECT line. Their output is printed
    back."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    for name, flags, _ in DRIVER_RUNS:
        cmd = [sys.executable, "-m", f"graphblast_tpu_torch.examples.{name}",
               "rmat:18:16"] + flags
        procs[name] = (cmd, subprocess.Popen(
            cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    failed = []
    for name, flags, correct in DRIVER_RUNS:
        cmd, proc = procs[name]
        try:
            out, err = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        secs = time.perf_counter() - t0
        for line in out.strip().splitlines():
            print(f"[{name}] {line}")
        lines = out.strip().splitlines()
        ok = (proc.returncode == 0 and len(lines) >= 2
              and lines[-2] == "cpu, warmup, tight, GTEPS"
              and (correct is None or any(line.startswith(correct)
                                          for line in lines)))
        if not ok:
            failed.append(f"{name} exited {proc.returncode}: {err[-1500:]}")
        print(f"[{name}] {' '.join(cmd[1:])}: exit {proc.returncode}, done "
              f"{secs:.2f} s after the six started"
              + ("" if correct else " (the golden skipped, as run_*.sh "
                 "TEST=1 does)"))
    if failed:
        raise AssertionError("drivers failed: " + "; ".join(failed))


@contextlib.contextmanager
def _numpy_ingest():
    """GRB_NATIVE=0 inside the block: io.mmio takes its NumPy path."""
    import os

    old = os.environ.get("GRB_NATIVE")
    os.environ["GRB_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GRB_NATIVE"]
        else:
            os.environ["GRB_NATIVE"] = old


def phase_native_ingest(n_expect: int):
    """rmat18's raw COO (rmat_edges(18, 16, 42), 4,194,304 edges) written
    by io.mmio.write_mtx as a pattern .mtx under a temporary directory,
    then read undirected by
    io.mmio.read_mtx on the native path and with GRB_NATIVE=0: the arrays
    equal, and the edge count rmat_matrix gives (n_expect). Both times
    printed, and those of canonicalize_coo alone on the raw arrays (what
    rmat_matrix runs), native and NumPy, equal too."""
    import os
    import tempfile

    import numpy as np

    from graphblast_tpu_torch import native
    from graphblast_tpu_torch.io import mmio
    from graphblast_tpu_torch.io.rmat import rmat_edges

    r, c = rmat_edges(18, 16, 42)
    n = 1 << 18
    ones = np.ones(len(r), np.float32)
    t0 = time.perf_counter()
    canon = mmio.canonicalize_coo(r, c, ones, undirected=True,
                                  remove_self_loops=True)
    canon_s = time.perf_counter() - t0
    with _numpy_ingest():
        t0 = time.perf_counter()
        canon_np = mmio.canonicalize_coo(r, c, ones, undirected=True,
                                         remove_self_loops=True)
        canon_np_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(canon, canon_np)):
        raise AssertionError("native canonicalize_coo differs from NumPy's")
    print(f"[native] canonicalize_coo of rmat18's raw COO ({len(r)} "
          f"edges, undirected): native {canon_s:.3f} s, NumPy "
          f"{canon_np_s:.3f} s ({canon_np_s / canon_s:.1f}x), equal")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rmat18.mtx")
        t0 = time.perf_counter()
        mmio.write_mtx(path, r, c, None, n, n, field="pattern")
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        if native.get_lib() is None:
            raise AssertionError("the native path is off (GRB_NATIVE)")
        t0 = time.perf_counter()
        got = mmio.read_mtx(path, directed=2)
        native_s = time.perf_counter() - t0
        with _numpy_ingest():
            t0 = time.perf_counter()
            want = mmio.read_mtx(path, directed=2)
            numpy_s = time.perf_counter() - t0
    for a, b, what in zip(got[:5], want[:5], ("rows", "cols", "vals",
                                              "nrows", "ncols")):
        same = (np.array_equal(a, b) and a.dtype == b.dtype
                if isinstance(b, np.ndarray) else a == b)
        if not same:
            raise AssertionError(f"native read_mtx differs from NumPy's in "
                                 f"{what}")
    if len(got[0]) != n_expect:
        raise AssertionError(f"native read_mtx: {len(got[0])} edges, "
                             f"rmat_matrix {n_expect}")
    print(f"[native] rmat18 raw COO as .mtx ({len(r)} lines, {size} B, "
          f"written in {write_s:.2f} s): read_mtx native {native_s:.3f} s, "
          f"NumPy (GRB_NATIVE=0) {numpy_s:.3f} s ({numpy_s / native_s:.1f}x);"
          f" {len(got[0])} canonical edges, arrays equal")


def _directions(golden, switchpoint: float) -> tuple:
    """(pull, push) iterations of the stepped dist BFS from the golden
    levels: iteration it holds the level-it frontier and pulls where its
    share of the vertices passes the switchpoint."""
    import numpy as np

    sizes = np.bincount(golden.astype(np.int64))[1:]
    pulls = int((sizes / len(golden) > switchpoint).sum())
    return pulls, len(sizes) - pulls


def phase_dist(A, sources, goldens, sssp_goldens, cc_golden, pr_golden,
               lgc_golden, reps: int = 3):
    """The distributed layer at world size 1 over NCCL on the card, at
    rmat18: bfs_dist pull and auto from the 8 hubs equal to the goldens
    (one K1 a pull iteration; 7 K6 a push iteration, the push's expansion);
    sssp_dist and cc_dist equal to the goldens of phases 7 and 8 (one S an
    iteration, and CC one K6 at the grandparents); pr_dist within phase
    5's bars (one value pull an iteration); lgc_dist from the hub within
    rtol 1e-3 / atol 1e-7 of lgc_cpu (K6 as phase 30). Each timed beside
    its single-device call (PageRank's loop over its prebuilt plan, as the
    dist partition's plan is built beforehand), both returning the result
    on the host. Then K1, the value pull and S at their dist call sites
    against their plain versions; last, scaling.py on the card as a
    subprocess. Returns the kernels line's three rows."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch import parallel as par
    from graphblast_tpu_torch.algorithms.pr import (
        _pr_fused, prepare_pr_matrix, prepare_pr_plan)
    from graphblast_tpu_torch.ops.kernels.bitmap_pull import (
        pack_bitmap, spmv_bitmap_pull, spmv_bitmap_pull_plain)
    from graphblast_tpu_torch.ops.kernels.minmax_pull import (
        spmv_minmax_pull, spmv_minmax_pull_plain)
    from graphblast_tpu_torch.ops.kernels.value_pull import (
        spmv_value_pull, spmv_value_pull_plain)

    last = par.algorithms.last_run
    t0 = time.perf_counter()
    mesh = par.global_mesh()
    print(f"[dist] mesh {mesh.size()} rank over "
          f"{dist.get_backend(mesh.get_group())}, torch {torch.__version__}, "
          f"joined in {time.perf_counter() - t0:.2f} s")
    if dist.get_backend(mesh.get_group()) != "nccl" or mesh.size() != 1:
        raise AssertionError("the dist phase needs one NCCL rank")
    t0 = time.perf_counter()
    Ash = par.partition(A, mesh)
    t1 = time.perf_counter()
    plan = Ash.pull_plan
    torch.cuda.synchronize()
    print(f"[dist] partition (CSR and CSC blocks) {t1 - t0:.2f} s, the K1 "
          f"plan and its schedule at first use {time.perf_counter() - t1:.2f}"
          f" s; n_pad {Ash.n_pad}, cap {Ash.csr_ind.shape[0]}")
    n = A.nrows
    group = mesh.get_group()
    xb = torch.rand(Ash.rows_per, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    ag_ms = _event_ms(lambda: par.ops.all_gather(xb, group), 200)
    ar_ms = _event_ms(lambda: par.ops.all_reduce(one, group=group), 200)
    clone_ms = _event_ms(lambda: xb.clone(), 200)
    read_s, _ = _timed_runs(lambda: int(par.ops.count(xb > 0.5, group)), 50)
    local_s, _ = _timed_runs(lambda: int((xb > 0.5).sum()), 50)
    print(f"[dist] NCCL at world size 1 (CUDA events over back-to-back "
          f"calls): all-gather of {Ash.rows_per} float32 {ag_ms:.6f} ms "
          f"(a clone of them {clone_ms:.6f} ms), all-reduce of one int32 "
          f"{ar_ms:.6f} ms; a count, its all-reduce and the host read "
          f"{read_s * 1e3:.6f} ms median of 50 (without the all-reduce "
          f"{local_s * 1e3:.6f} ms)")
    k1 = 0
    for mode in ("pull", "auto"):
        _reset_counts()
        levels = [par.bfs_dist(A, int(s), mesh, mode=mode, Ash=Ash)
                  for s in sources]
        counts = _read_counts()
        pulls = pushes = 0
        for s, v, want in zip(sources, levels, goldens):
            if v.shape != (n,) or not np.array_equal(v, want):
                raise AssertionError(f"bfs_dist {mode} from {s}: levels != "
                                     "golden")
            d = (_directions(want, gt.BFS_TUNED.switchpoint) if mode == "auto"
                 else (int(want.max()), 0))
            pulls, pushes = pulls + d[0], pushes + d[1]
        _expect_launches(f"bfs_dist {mode}", {
            "bitmap_pull": pulls, "gather_boundary": 7 * pushes}, counts)
        k1 += pulls
        print(f"[dist] bfs_dist {mode} from {len(sources)} hubs: levels == "
              f"golden; {pulls} pull and {pushes} push iterations; "
              f"launches {counts}")
    desc_pull = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PULLONLY)
    srcs = [int(s) for s in sources]

    def timed(tag, dist_fn, single_fn, runs, single_tag="single-device"):
        d_s, d_tail = _timed_runs(dist_fn, runs)
        s_s, s_tail = _timed_runs(single_fn, runs)
        print(f"[dist] {tag}: {d_s * 1e3:.6f} ms/run median ({d_tail}), "
              f"{single_tag} {s_s * 1e3:.6f} ms/run ({s_tail}), "
              f"{runs} runs each, both to a host array")

    it = iter(srcs * reps * 4)
    timed("bfs pull", lambda: par.bfs_dist(A, next(it), mesh, mode="pull",
                                           Ash=Ash),
          lambda: gt.algorithms.bfs(A, next(it), desc_pull).to_numpy(),
          len(srcs) * reps)
    timed("bfs auto", lambda: par.bfs_dist(A, next(it), mesh, Ash=Ash),
          lambda: gt.algorithms.bfs(A, next(it)).to_numpy(),
          len(srcs) * reps)

    _reset_counts()
    iters = 0
    for s, want in zip(srcs, sssp_goldens):
        d = par.sssp_dist(A, s, mesh, Ash=Ash)
        iters += last["sssp"]["iterations"]
        if d.shape != (n,) or not np.array_equal(d, want):
            raise AssertionError(f"sssp_dist from {s}: != golden")
    counts = _expect_launches("sssp_dist", {"minmax_pull": iters})
    s_launches = iters
    print(f"[dist] sssp_dist from {len(srcs)} hubs: distances == golden; "
          f"{iters} iterations, launches {counts}")
    sssp_desc = gt.DEFAULT.replace(mxv_mode=gt.Direction.PULLONLY)
    it = iter(srcs * reps * 2)
    timed("sssp", lambda: par.sssp_dist(A, next(it), mesh, Ash=Ash),
          lambda: gt.algorithms.sssp(A, next(it), sssp_desc).to_numpy(),
          len(srcs) * reps)

    _reset_counts()
    labels = par.cc_dist(A, mesh, Ash=Ash)
    counts = _read_counts()
    iters = last["cc"]["iterations"]
    if not np.array_equal(labels, cc_golden):
        raise AssertionError("cc_dist: labels != golden")
    _expect_launches("cc_dist", {"minmax_pull": iters, "gather_x": iters},
                     counts)
    s_launches += iters
    print(f"[dist] cc_dist: labels == golden; {iters} iterations, launches "
          f"{counts}")
    timed("cc", lambda: par.cc_dist(A, mesh, Ash=Ash),
          lambda: gt.algorithms.cc(A).to_numpy(), 5 * reps)

    t0 = time.perf_counter()
    Apr = par.partition(prepare_pr_matrix(A, PR_ALPHA), mesh)
    vplan = Apr.value_pull_plan
    torch.cuda.synchronize()
    print(f"[dist] PageRank's prepared partition with its value-pull plan "
          f"{time.perf_counter() - t0:.2f} s")
    _reset_counts()
    p = par.pr_dist(A, mesh, alpha=PR_ALPHA, eps=PR_EPS, Ash=Apr)
    counts = _read_counts()
    pr_iters = last["pr"]["iterations"]
    l1 = float(np.abs(p.astype(np.float64) - pr_golden).sum())
    top = np.argsort(pr_golden)[::-1][:100]
    top_rel = float((np.abs(p[top] - pr_golden[top]) / pr_golden[top]).max())
    if not (p.shape == (n,) and l1 <= 1e-4 and top_rel <= 1e-3):
        raise AssertionError(f"pr_dist vs golden: L1 {l1} (bar 1e-4), "
                             f"top-100 rel {top_rel} (bar 1e-3)")
    _expect_launches("pr_dist", {"value_pull": pr_iters}, counts)
    print(f"[dist] pr_dist: {pr_iters} iterations, sum|p - p_gold| {l1:.3e} "
          f"(bar 1e-4), top-100 rel {top_rel:.3e} (bar 1e-3); launches "
          f"{counts}")
    pr_plan = prepare_pr_plan(A, PR_ALPHA)
    timed("pr", lambda: par.pr_dist(A, mesh, alpha=PR_ALPHA, eps=PR_EPS,
                                    Ash=Apr),
          lambda: _pr_fused(A, pr_plan, alpha=PR_ALPHA, eps=PR_EPS,
                            max_niter=gt.DEFAULT.max_niter)[0].cpu().numpy(),
          5 * reps, single_tag="single-device loop over its prebuilt plan")

    hub = srcs[0]
    _reset_counts()
    q = par.lgc_dist(A, hub, mesh, alpha=0.15, eps=1e-6, Ash=Ash)
    counts = _read_counts()
    iters = last["lgc"]["iterations"]
    if not (q.shape == (n,) and np.isfinite(q).all() and np.allclose(
            q, lgc_golden, rtol=1e-3, atol=1e-7)):
        raise AssertionError("lgc_dist: past rtol 1e-3 / atol 1e-7 of "
                             "lgc_cpu")
    _expect_launches("lgc_dist", {"gather_x": iters,
                                  "gather_boundary": iters + 1}, counts)
    print(f"[dist] lgc_dist from the hub: within rtol 1e-3 / atol 1e-7 of "
          f"lgc_cpu (max diff {float(np.abs(q - lgc_golden).max())}); "
          f"{iters} iterations, launches {counts}")
    timed("lgc", lambda: par.lgc_dist(A, hub, mesh, alpha=0.15, eps=1e-6,
                                      Ash=Ash),
          lambda: gt.algorithms.lgc(A, hub, alpha=0.15,
                                    eps=1e-6).to_numpy(), 2 * reps)

    # the kernels at their dist call sites, on the blocks' arrays
    nnz = int(plan.ptr[-1])
    f = torch.zeros(Ash.n_pad, dtype=torch.float32, device="cuda")
    f[:n] = torch.from_numpy((goldens[0] == 2).astype(np.float32)).cuda()
    words = pack_bitmap(f)
    ones = torch.sparse_csr_tensor(
        plan.ptr, plan.ind[:nnz], torch.ones(nnz, device="cuda"),
        size=(plan.n_out, plan.n_in), check_invariants=False)
    rows = {"bitmap_pull_dist": _site_row(
        "K1 at bfs_dist's pull (the hub's level-2 frontier)",
        lambda: spmv_bitmap_pull(plan, words),
        lambda: spmv_bitmap_pull_plain(plan, words),
        4 * (nnz + (plan.n_out + 1) + words.shape[0] + plan.n_out),
        lambda: torch.mv(ones, f))}
    vnnz = int(vplan.ptr[-1])
    x = torch.from_numpy(np.random.default_rng(35).standard_normal(
        Ash.n_pad).astype(np.float32)).cuda()
    vmat = torch.sparse_csr_tensor(vplan.ptr, vplan.ind[:vnnz],
                                   vplan.val[:vnnz], size=(vplan.n_out,
                                                           vplan.n_in),
                                   check_invariants=False)
    rows["value_pull_dist"] = _site_row(
        "value pull at pr_dist's pull", lambda: spmv_value_pull(vplan, x),
        lambda: spmv_value_pull_plain(vplan, x),
        8 * vnnz + 4 * (vplan.n_out + 1) + 4 * vplan.n_in + 4 * vplan.n_out,
        lambda: torch.mv(vmat, x), rel_tol=1e-5)
    ptr, ind, val = Ash.csc()
    snnz = ind.shape[0]
    sched = Ash.schedule(True)
    rng = np.random.default_rng(36)
    xs = rng.uniform(0.0, 5.0, Ash.n_pad).astype(np.float32)
    xs[rng.random(Ash.n_pad) < 0.4] = MAXF32
    xs = torch.from_numpy(xs).cuda()
    sr = gt.MinimumPlusSemiring
    prod = (val + xs[ind.long()]).contiguous()
    rows["minmax_pull_dist"] = _site_row(
        "S at sssp_dist's MinimumPlus pull",
        lambda: spmv_minmax_pull(ptr, ind, val, xs, sr, Ash.rows_per,
                                 sched=sched),
        lambda: spmv_minmax_pull_plain(ptr, ind, val, xs, sr, Ash.rows_per),
        8 * snnz + 4 * (Ash.rows_per + 1) + 4 * Ash.n_pad + 4 * Ash.rows_per,
        lambda: torch.segment_reduce(prod, "min", offsets=ptr.long(),
                                     initial=sr.identity(
                                         torch.float32).item()))
    rows["bitmap_pull_dist"]["launches"] = k1
    rows["value_pull_dist"]["launches"] = pr_iters
    rows["minmax_pull_dist"]["launches"] = s_launches
    dist.destroy_process_group()

    # examples/scaling.py on the card: a rank a card through
    # parallel.launch (a spawned process over a file store), P = 1
    cmd = [sys.executable, "-m", "graphblast_tpu_torch.examples.scaling",
           "--scale", "18", "--algo", "bfs", "--niter", "3"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=300)
    out = run.stdout.strip().splitlines()
    for line in out:
        print(f"[scaling] {line}")
    if (run.returncode != 0 or len(out) != 3
            or out[1] != "P, ms/run, Medges/s, efficiency_vs_P1"
            or not out[2].startswith("1, ")):
        raise AssertionError(f"scaling.py exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    print(f"[scaling] {' '.join(cmd[1:])}: exit 0 in "
          f"{time.perf_counter() - t0:.2f} s")
    return rows


def _dual_directions(A, golden, switchpoint: float, edge_cap: int,
                     n_pad: int) -> list:
    """The dual BFS's (count, edge maximum, direction) each iteration,
    replayed on the host from the golden levels by the JAX loop's rule
    at world size 1: push iff count / n_pad <= switchpoint and the
    frontier's edges fit edge_cap."""
    import numpy as np

    deg = np.diff(A.host_csr()[0].astype(np.int64))
    out = []
    for it in range(1, int(golden.max()) + 1):
        front = golden == it
        succ, edges = int(front.sum()), int(deg[front].sum())
        push = succ / n_pad <= switchpoint and edges <= edge_cap
        out.append((succ, edges, "push" if push else "pull"))
    return out


def phase_dist_second_half(A, sources, goldens, pr_golden, t1_library_ms,
                           reps: int = 3):
    """The second half of the distributed layer at world size 1 over NCCL
    at rmat18 (phase 36): bfs_dist(mode="dual") from the 8 hubs equal to
    the goldens, its directions equal to a host replay of the JAX rule
    (one K1 a pull iteration, 9 K6 a push and 2 each iteration for the
    frontier's state, all at ascending indices); pr_dist(comm="ring") and
    (comm="2d") within phase 5's bars (one K6 at the ids and one at the
    boundaries a stage, and one for the out-degrees); tc_dist on tril(A)
    equal to tc()'s count, one T1 launch a stage, and tc_prepare's time;
    mis_dist and gc_dist (seed 1) verified, and equal to the
    single-device mis and gc(is) handed the same weights;
    partition_cached built, saved and loaded, timed, equal arrays;
    owner_buckets' count for the hub's level-2 frontier equal to
    accounting.sparse_push_live_pairs. Each entry is timed beside its
    single-device call, both ending in a host array. Then K6 at the ring
    stage's gather and T1 at tc_dist's stage against their plain versions.
    Returns the kernels line's two rows."""
    import importlib
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch import parallel as par
    from graphblast_tpu_torch.algorithms.pr import (
        _pr_fused, prepare_pr_matrix, prepare_pr_plan)
    from graphblast_tpu_torch.ops.kernels.gather import (gather_1d,
                                                         gather_1d_plain)
    from graphblast_tpu_torch.ops.kernels.masked_intersect import (
        masked_intersect_count, masked_intersect_count_plain)
    from graphblast_tpu_torch.parallel.accounting import (
        sparse_push_live_pairs)
    from graphblast_tpu_torch.parallel.partition import LEAVES

    last = par.algorithms.last_run
    t0 = time.perf_counter()
    mesh = par.global_mesh()
    mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=("r", "c"))
    if dist.get_backend(mesh.get_group()) != "nccl" or mesh.size() != 1:
        raise AssertionError("the dist phase needs one NCCL rank")
    Ash = par.partition(A, mesh)
    torch.cuda.synchronize()
    print(f"[dist2] mesh of 1 NCCL rank and a 1 x 1 mesh (r, c); "
          f"partition {time.perf_counter() - t0:.2f} s")
    n = A.nrows
    srcs = [int(s) for s in sources]

    def timed(tag, dist_fn, single_fn, runs, single_tag="single-device"):
        d_s, d_tail = _timed_runs(dist_fn, runs)
        s_s, s_tail = _timed_runs(single_fn, runs)
        print(f"[dist2] {tag}: {d_s * 1e3:.6f} ms/run median ({d_tail}), "
              f"{single_tag} {s_s * 1e3:.6f} ms/run ({s_tail}), {runs} runs "
              f"each, both to a host array")

    # the fused dual-direction BFS
    sw = gt.BFS_TUNED.switchpoint
    _reset_counts()
    pulls = pushes = iters = reads = 0
    for s, want in zip(srcs, goldens):
        v = par.bfs_dist(A, s, mesh, mode="dual", Ash=Ash)
        run = last["bfs"]
        if v.shape != (n,) or not np.array_equal(v, want):
            raise AssertionError(f"bfs_dist dual from {s}: levels != golden")
        replay = _dual_directions(A, want, sw, run["edge_cap"], Ash.n_pad)
        if [tuple(d) for d in run["directions"]] != replay:
            raise AssertionError(f"bfs_dist dual from {s}: directions "
                                 f"{run['directions']} != replay {replay}")
        iters += run["iterations"]
        pulls += run["pull_iterations"]
        pushes += run["iterations"] - run["pull_iterations"]
        reads += run["host_reads"]
    counts = _expect_launches("bfs_dist dual", {
        "bitmap_pull": pulls,
        "gather_boundary": 2 * (iters + len(srcs)) + 9 * pushes})
    if reads > 2 * iters + len(srcs):
        raise AssertionError(f"bfs_dist dual: {reads} host reads in {iters} "
                             "iterations")
    print(f"[dist2] bfs_dist dual from {len(srcs)} hubs: levels == golden, "
          f"directions == the host replay of the JAX rule; {pulls} pull and "
          f"{pushes} push iterations, {reads} host reads; edge_cap "
          f"{run['edge_cap']}, pair_cap {run['pair_cap']}; launches {counts}")
    it = iter(srcs * reps * 4)
    timed("bfs dual", lambda: par.bfs_dist(A, next(it), mesh, mode="dual",
                                           Ash=Ash),
          lambda: gt.algorithms.bfs(A, next(it)).to_numpy(), len(srcs) * reps,
          single_tag="single-device PUSHPULL bfs")

    # the accounting's live pairs at the hub's level-2 frontier
    f = torch.from_numpy((goldens[0] == 2).astype(np.float32)).cuda()
    f_ind, _, f_nv = par.ops.local_frontier(f, 0.0)
    _, _, _, (_, cnt) = par.ops.owner_buckets(
        *Ash.csr(), f_ind, None, f_nv, gt.LogicalOrAndSemiring, 1,
        Ash.rows_per, Ash.csr_ind.shape[0], True, torch.float32)
    ptr, ind = A.host_csr()[:2]
    want_pairs = sparse_push_live_pairs(ptr, ind, goldens[0] == 2, 1,
                                        Ash.rows_per)
    if cnt.cpu().tolist() != want_pairs[0].tolist():
        raise AssertionError(f"owner_buckets {cnt.tolist()} != accounting "
                             f"{want_pairs.tolist()}")
    print(f"[dist2] owner_buckets at the hub's level-2 frontier: "
          f"{cnt.tolist()} live pairs == accounting.sparse_push_live_pairs")

    # PageRank over the ring and the 2D layout
    def pr_check(tag, p):
        l1 = float(np.abs(p.astype(np.float64) - pr_golden).sum())
        top = np.argsort(pr_golden)[::-1][:100]
        rel = float((np.abs(p[top] - pr_golden[top]) / pr_golden[top]).max())
        if not (p.shape == (n,) and l1 <= 1e-4 and rel <= 1e-3):
            raise AssertionError(f"{tag} vs golden: L1 {l1} (bar 1e-4), "
                                 f"top-100 rel {rel} (bar 1e-3)")
        return f"sum|p - p_gold| {l1:.3e} (bar 1e-4), top-100 rel {rel:.3e}"

    Ap = prepare_pr_matrix(A, PR_ALPHA)
    ring_launches = 0
    for comm, key in (("ring", "pr_ring"), ("2d", "pr_2d")):
        _reset_counts()
        t0 = time.perf_counter()
        p = par.pr_dist(A, mesh if comm == "ring" else mesh2, alpha=PR_ALPHA,
                        eps=PR_EPS, comm=comm)
        call_s = time.perf_counter() - t0
        pr_iters = last[key]["iterations"]
        # and one at the boundaries for prepare_pr_matrix's out-degrees
        counts = _expect_launches(f"pr_dist {comm}", {
            "gather_x": pr_iters, "gather_boundary": pr_iters + 1})
        if comm == "ring":
            ring_launches = counts["gather_x"]
        print(f"[dist2] pr_dist comm={comm}: {pr_iters} iterations (one "
              f"stage each at P = 1), {pr_check(comm, p)}; launches {counts}; "
              f"the call with its partition {call_s:.2f} s")
    t0 = time.perf_counter()
    Rsh = par.partition_ring(gt.transpose(Ap), mesh)
    t1 = time.perf_counter()
    A2 = par.partition_2d(gt.transpose(Ap), mesh2)
    torch.cuda.synchronize()
    print(f"[dist2] partition_ring of Aᵀ {t1 - t0:.2f} s, partition_2d "
          f"{time.perf_counter() - t1:.2f} s")
    ring_run = par.make_pr_ring_dist(mesh, Rsh, PR_ALPHA, PR_EPS)
    run_2d = par.make_pr_2d_dist(mesh2, A2, PR_ALPHA, PR_EPS)
    pr_plan = prepare_pr_plan(A, PR_ALPHA)
    single = lambda: _pr_fused(  # noqa: E731
        A, pr_plan, alpha=PR_ALPHA, eps=PR_EPS,
        max_niter=gt.DEFAULT.max_niter)[0].cpu().numpy()
    timed("pr ring (over its partition)",
          lambda: ring_run().cpu().numpy(), single, reps,
          single_tag="single-device loop over its prebuilt plan")
    timed("pr 2d (over its partition)", lambda: run_2d().cpu().numpy(),
          single, reps, single_tag="single-device loop over its prebuilt plan")

    # TC over the ring of row blocks
    L = gt.tril(A)
    t0 = time.perf_counter()
    prep = par.tc_prepare(L, mesh)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    want_tc = gt.algorithms.tc(L)
    _reset_counts()
    got_tc = par.tc_dist(L, mesh, prep=prep)
    counts = _expect_launches("tc_dist", {"masked_intersect_count": 1})
    if got_tc != want_tc or got_tc != 82_996_539:
        raise AssertionError(f"tc_dist {got_tc} != tc() {want_tc} or the "
                             "recorded 82,996,539")
    t1_launches = counts["masked_intersect_count"]
    print(f"[dist2] tc_dist of tril(A): {got_tc:,} == tc() and the record; "
          f"one stage, launches {counts}; tc_prepare {prep_s:.2f} s (L's "
          f"partition and the mask-edge buckets; ec {prep.ec}, all values 1: "
          f"{prep.unit})")
    timed("tc", lambda: par.tc_dist(L, mesh, prep=prep),
          lambda: gt.algorithms.tc(L), reps)

    # MIS and IS colouring
    _reset_counts()
    m = par.mis_dist(A, mesh, seed=1, Ash=Ash)
    rounds = last["mis"]["iterations"]
    counts = _expect_launches("mis_dist", {
        "minmax_pull": rounds, "gather_x": rounds, "gather_boundary": rounds})
    if not gt.algorithms.verify_mis(A, m):
        raise AssertionError("mis_dist: verify_mis fails")
    _reset_counts()
    c = par.gc_dist(A, mesh, seed=1, Ash=Ash)
    gc_rounds = last["gc"]["iterations"]
    counts_gc = _expect_launches("gc_dist", {"minmax_pull": gc_rounds})
    if not (gt.algorithms.verify_gc(A, c) and c.min() >= 1):
        raise AssertionError("gc_dist: verify_gc fails")
    mis_mod = importlib.import_module("graphblast_tpu_torch.algorithms.mis")
    gc_mod = importlib.import_module("graphblast_tpu_torch.algorithms.gc")
    w0 = mis_mod.random_weights(n, 1, "cuda")
    wb = torch.zeros(Ash.rows_per, dtype=torch.int32, device="cuda")
    wb[:n] = w0
    m_w = par.make_mis_dist(mesh, Ash, weights=wb)()[:n].cpu().numpy()
    c_w = par.make_gc_dist(mesh, Ash, weights=wb)()[:n].cpu().numpy()
    m_1 = mis_mod.mis_inner(A, w0).cpu().numpy()
    c_1, _ = gc_mod._gc_is_fused(A, w0, max_niter=gt.DEFAULT.max_niter)
    if not (np.array_equal(m_w, m_1)
            and np.array_equal(c_w, c_1.cpu().numpy())):
        raise AssertionError("mis_dist / gc_dist handed the single-device "
                             "weights differ from mis / gc(is)")
    print(f"[dist2] mis_dist seed 1: verify_mis holds, {int(m.sum())} in "
          f"the set, {rounds} rounds, launches {counts}; gc_dist seed 1: "
          f"verify_gc holds, {int(c.max())} colours, {gc_rounds} rounds, "
          f"launches {counts_gc}; both equal mis and gc(is) handed the same "
          "weights")
    timed("mis", lambda: par.mis_dist(A, mesh, seed=1, Ash=Ash),
          lambda: gt.algorithms.mis(A, seed=1).to_numpy(), reps)
    timed("gc", lambda: par.gc_dist(A, mesh, seed=1, Ash=Ash),
          lambda: gt.algorithms.gc(A, seed=1).to_numpy(), reps)

    # the partition cache
    with tempfile.TemporaryDirectory(prefix="grb-shards-") as tmp:
        base = os.path.join(tmp, "rmat18.mtx")
        t0 = time.perf_counter()
        built = par.partition_cached(A, mesh, base)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loaded = par.partition_cached(A, mesh, base)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(par.shard_cache_path(base, 1, 0))
        same = all(torch.equal(getattr(built, k), getattr(loaded, k))
                   for k in LEAVES)
        if not same:
            raise AssertionError("partition_cached: loaded != built")
    print(f"[dist2] partition_cached: built and saved {t1 - t0:.2f} s "
          f"({size} B), loaded {t2 - t1:.2f} s, arrays equal")

    # K6 at the ring stage's gather, T1 at tc_dist's stage
    _, rind, _ = Rsh.block(0)
    x = torch.from_numpy(np.random.default_rng(36).random(
        Rsh.rows_per).astype(np.float32)).cuda()
    m_ids = rind.shape[0]
    rows = {"gather_ring": _site_row(
        "K6 at the ring stage's gather (x at the column ids)",
        lambda: gather_1d(x, rind), lambda: gather_1d_plain(x, rind),
        4 * (2 * m_ids + min(Rsh.rows_per, m_ids)),
        lambda: torch.index_select(x, 0, rind))}
    rows["gather_ring"]["launches"] = ring_launches
    mi, mj = prep.edges(0)
    lptr, lind, _ = prep.Ash.csr()
    sched = prep.schedules[(0, True)]
    args = (mi, mj, lptr, lind, prep.Ash.csr_ptr, prep.Ash.csr_ind)
    count = lambda: masked_intersect_count(*args, sched=sched)  # noqa: E731
    got, again = count(), count()
    plain = masked_intersect_count_plain(*args)
    if not got == again == plain == got_tc:
        raise AssertionError(f"T1 at tc_dist's stage: {got}, again {again}, "
                             f"plain {plain}")
    ms = _event_ms(count, 20)
    plain_ms = _event_ms(lambda: masked_intersect_count_plain(*args), 1)
    bound_bytes = 8 * mi.shape[0] + 4 * (lptr.shape[0])
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[T1 dist] at tc_dist's stage: {got:,} == plain == a second "
          f"launch; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, library "
          f"(phase 15's torch.sparse.mm of L by Lᵀ) {t1_library_ms} ms, "
          f"bound {bound_bytes} B -> {bound_ms:.6f} ms at 3.35 TB/s")
    rows["masked_intersect_count_dist"] = dict(
        max_abs_err=abs(got - plain), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, library_ms=t1_library_ms, launches=t1_launches)
    dist.destroy_process_group()
    return rows


# ------------------------------------------------ RMAT 20 and 22 (bench.py)
# the larger stages' graphs (bench.py:615-673), edge factor 16, seed 42,
# with their sizes after symmetrizing and deduplicating
BIG_SCALES = (20, 22)
RMAT_NNZ = {20: 31_399_912, 22: 128_304_760}


@contextlib.contextmanager
def _no_generation():
    """io.rmat.rmat_edges raises inside the block: a graph must come from
    its cache file."""
    from graphblast_tpu_torch.io import rmat

    real = rmat.rmat_edges

    def refuse(*_, **__):
        raise AssertionError("rmat_matrix generated a graph its cache holds")

    rmat.rmat_edges = refuse
    try:
        yield
    finally:
        rmat.rmat_edges = real


def _cached_rmat(scale: int, cache_dir: str, record: bool = False):
    """rmat_matrix(scale, 16, 42) on the card, read from its cache file
    (generation refused); prints the file, the cache load alone and the
    whole call. With `record`, a utils.profiling.MemorySteps made after
    the cache load hears the build's steps. Returns the Matrix and the
    recorder (None without `record`)."""
    import os

    import torch

    from graphblast_tpu_torch.io.rmat import cache_path, load_coo, rmat_matrix
    from graphblast_tpu_torch.utils.profiling import MemorySteps

    path = cache_path(scale, 16, 42, cache_dir)
    t0 = time.perf_counter()
    load_coo(path)
    load_s = time.perf_counter() - t0
    rec = MemorySteps() if record else None
    t0 = time.perf_counter()
    with _no_generation():
        A = rmat_matrix(scale, 16, seed=42, device="cuda",
                        cache_dir=cache_dir, steps=rec)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    if (A.nrows, A.nvals) != (1 << scale, RMAT_NNZ[scale]):
        raise AssertionError(f"rmat{scale}: n={A.nrows} nnz={A.nvals}, "
                             f"expected {1 << scale} and {RMAT_NNZ[scale]}")
    print(f"[graph] rmat{scale}: n={A.nrows} nnz={A.nvals} from the cache "
          f"file ({os.path.getsize(path)} B) through rmat_matrix in "
          f"{total_s:.2f} s: the cache load alone {load_s:.2f} s, the "
          f"Matrix build on the card the rest, {total_s - load_s:.2f} s")
    return A, rec


def phase_rmat_cache(cache_dir: str) -> None:
    """Runs the port's cache tool (python -m graphblast_tpu_torch.tools.
    gen_rmat_cache 20 22) writing into cache_dir and prints its lines:
    each graph's generation, canonicalize and write seconds."""
    import os

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "graphblast_tpu_torch.tools.gen_rmat_cache",
         *map(str, BIG_SCALES)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=900,
        env=dict(os.environ, GRB_RMAT_CACHE_DIR=cache_dir))
    for line in out.stdout.splitlines():
        print(f"[rmat cache] {line}")
    if out.returncode != 0:
        raise AssertionError(f"gen_rmat_cache exited {out.returncode}")
    print(f"[rmat cache] the tool ran {time.perf_counter() - t0:.2f} s")


def _top_sources(A, k: int):
    import numpy as np

    deg = np.diff(A.host_csr()[0])
    return np.argsort(deg, kind="stable")[::-1][:k].astype(np.int64)


def phase_rmat22(cache_dir: str):
    """bench.py's bfs22 and spmv22 stages at RMAT 22, the graph read from
    the port's cache through rmat_matrix, its build's card memory printed
    by step and held to 40 B an edge: K1 against its plain version and
    torch.sparse (phase 2's checks); pull-only BFS from the 4 top-degree
    hubs equal to the golden, one K1 launch an iteration (phase 3's); the
    value pull over the CSR with a seeded x (phase 4's checks) and, as
    bench.py's spmv stage, max |y - y64| / (|y64| + 1) < 1e-3 against a
    float64 golden; then 10 PULLONLY mxv_dual calls over the plan, one
    value-pull launch each, equal to the kernel. Returns the K1 row, its
    bound, BFS's launches, the value pull's row and its launches."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.algorithms.reference import bfs_cpu
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual
    from graphblast_tpu_torch.ops.kernels.value_pull import (plan_for,
                                                             spmv_value_pull)

    A, rec = _cached_rmat(22, cache_dir, record=True)
    for line in rec.lines("[build] rmat22", A.nvals):
        print(line)
    per_edge = rec.peak() / A.nvals
    print(f"[build] rmat22: {rec.peak()} B the most allocated by the build "
          f"above its start, {per_edge:.2f} B an edge (bar 40)")
    if not per_edge <= 40:
        raise AssertionError(f"rmat22: the build peaks at {per_edge:.2f} B "
                             "an edge, bar 40")
    sources = _top_sources(A, 4)
    t0 = time.perf_counter()
    goldens = [bfs_cpu(A, int(s)) for s in sources]
    print(f"[bfs22] goldens of {len(sources)} hubs in "
          f"{time.perf_counter() - t0:.2f} s")
    k1, k1_bound = phase_kernel_vs_plain(A, goldens[0], int(sources[0]),
                                         tag="K1 rmat22")
    launches, per_s, iters = phase_main_path(A, sources, goldens, reps=3,
                                             label="rmat22")
    print(f"[bfs22] K1 time per run ({iters[0]} launches x "
          f"{k1['hub_level2']['ms']:.6f} ms at the hub's level 2) beside "
          f"the median run {per_s * 1e3:.6f} ms")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.ncols).astype(np.float32)).cuda()
    plan = plan_for(A)
    k2 = phase_value_pull("K2 rmat22", plan, x, plain_reps=5)
    nnz = int(plan.ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device="cuda"),
        (plan.ptr[1:] - plan.ptr[:-1]).long(), output_size=nnz)
    gold = torch.zeros(plan.n_out, dtype=torch.float64, device="cuda")
    gold.index_add_(0, rows, plan.val[:nnz].double()
                    * x.double()[plan.ind[:nnz].long()])
    y = spmv_value_pull(plan, x)
    err = float(((y.double() - gold).abs() / (gold.abs() + 1)).max())
    if not err < 1e-3:
        raise AssertionError(f"spmv22: err {err} against the float64 "
                             "golden, bar 1e-3")
    # the pull as a user's mxv_dual makes it over the plan, counted
    frontier = DualFrontier.from_dense(x, 0.0)
    _reset_counts()
    for _ in range(10):
        f2, _ = mxv_dual(A, frontier, gt.PlusMultipliesSemiring, 0.0,
                         mode=gt.Direction.PULLONLY, pull_plan=plan)
    k2_launches = _expect_launches("spmv22 mxv_dual",
                                   {"value_pull": 10})["value_pull"]
    if not torch.equal(f2.dense, y):
        raise AssertionError("spmv22: mxv_dual differs from the kernel")
    gb_s = (8 * nnz + 4 * (plan.n_out + 1) + 4 * plan.n_in
            + 4 * plan.n_out) / (k2["ms"] * 1e-3) / 1e9
    print(f"[spmv22] err {err:.3g} against the float64 golden (bar 1e-3); "
          f"{gb_s:.3f} GB/s, {nnz / (k2['ms'] * 1e-3) / 1e9:.6f} GTEPS at "
          f"{k2['ms']:.6f} ms")
    del A, plan, rows, gold, frontier, f2
    torch.cuda.empty_cache()
    return k1["hub_level2"], k1_bound, launches, k2, k2_launches


def phase_mtx20(tmp_dir: str) -> None:
    """bench.py's mtx stage: RMAT 20's raw COO (rmat_edges(20, 16, 42))
    written by io.mmio.write_mtx as a pattern .mtx, read directed by
    io.mmio.read_mtx on the native path, built on the card, and BFS
    pull-only from its 4 top-degree sources equal to the golden, one K1
    launch an iteration. Prints the write, parse and build seconds and the
    parse's MB/s."""
    import os

    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch import native
    from graphblast_tpu_torch.algorithms.reference import bfs_cpu
    from graphblast_tpu_torch.io import mmio
    from graphblast_tpu_torch.io.rmat import rmat_edges

    n = 1 << 20
    t0 = time.perf_counter()
    r, c = rmat_edges(20, 16, 42)
    gen_s = time.perf_counter() - t0
    path = os.path.join(tmp_dir, "rmat20_16.mtx")
    t0 = time.perf_counter()
    mmio.write_mtx(path, r, c, None, n, n, field="pattern")
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    del r, c
    if native.get_lib() is None:
        raise AssertionError("the native path is off (GRB_NATIVE)")
    t0 = time.perf_counter()
    rows, cols, vals, nr, nc, info = mmio.read_mtx(path, directed=1)
    parse_s = time.perf_counter() - t0
    os.remove(path)
    t0 = time.perf_counter()
    A = gt.Matrix.from_coo(rows, cols, vals, nr, nc, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[mtx] rmat20 raw COO generated in {gen_s:.2f} s, written by "
          f"write_mtx ({info.field} {info.symmetry}, {size} B) in "
          f"{write_s:.2f} s; native read_mtx (directed) {parse_s:.2f} s, "
          f"{size / parse_s / 1e6:.0f} MB/s, {A.nvals} edges; built on the "
          f"card in {build_s:.2f} s")
    sources = _top_sources(A, 4)
    goldens = [bfs_cpu(A, int(s)) for s in sources]
    phase_main_path(A, sources, goldens, reps=3, label="mtx rmat20")
    del A
    torch.cuda.empty_cache()


def phase_tc20(cache_dir: str, reps: int = 10):
    """bench.py's tc20 stage: L = tril(A) of RMAT 20 (read from the
    cache), tc(L) warm, then `reps` timed calls, one T1 launch each; the
    count equal to T1's plain version on the card and to a second
    launch. Returns T1's kernels-line row and the timed calls' launches."""
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops import spgemm as sp
    from graphblast_tpu_torch.ops.kernels.masked_intersect import (
        masked_intersect_count, masked_intersect_count_plain)

    A, _ = _cached_rmat(20, cache_dir)
    t0 = time.perf_counter()
    L = gt.tril(A)
    torch.cuda.synchronize()
    print(f"[tc20] L = tril(A): nnz={L.nvals}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    _reset_counts()
    t0 = time.perf_counter()
    ntris = gt.algorithms.tc(L)
    first_s = time.perf_counter() - t0
    _expect_launches("tc20 first", {"masked_intersect_count": 1})
    args = sp._count_args(sp._operands(L, L, L, True))
    sched = L._plans["intersect/mask"][0][2]
    again = masked_intersect_count(*args, sched=sched)
    t0 = time.perf_counter()
    plain = masked_intersect_count_plain(*args)
    plain_s = time.perf_counter() - t0
    if not ntris == again == plain:
        raise AssertionError(f"tc20: {ntris}, again {again}, plain {plain}")
    _reset_counts()
    per_s, tail = _timed_runs(lambda: gt.algorithms.tc(L), reps)
    _expect_launches("tc20", {"masked_intersect_count": reps})
    launches = _read_counts()["masked_intersect_count"]
    ms = _event_ms(lambda: masked_intersect_count(*args, sched=sched), reps)
    m, n = L.nvals, L.nrows
    bound_ms = (8 * m + 4 * (n + 1)) / HBM_BYTES_PER_S * 1e3
    lib_ms, lib_text = _library_spgemm(L)
    print(f"[tc20] tc(L) = {ntris} triangles, equal to T1's plain version "
          f"({plain_s:.2f} s) and a second launch; first call (the lists' "
          f"check and the schedule) {first_s:.2f} s; {per_s * 1e3:.6f} "
          f"ms/run median, {tail}; {A.nvals / per_s / 1e6:.3f} M edges/s "
          f"(A's nnz over a call); one T1 launch a call; T1 alone "
          f"{ms:.6f} ms, bound {bound_ms:.6f} ms (inputs once at 3.35 "
          f"TB/s); library {lib_text}")
    del A, L
    torch.cuda.empty_cache()
    return dict(max_abs_err=abs(again - plain), ms=ms,
                plain_ms=plain_s * 1e3, bound_ms=bound_ms,
                library_ms=lib_ms), launches


ORDERED_SEMIRINGS = ("GreaterPlus", "CustomLessPlus", "CustomLessLess",
                     "NotEqualToPlus", "MultipliesMultiplies")


def phase_ordered_folds(L, reps: int = 20):
    """T2's ordered folds (the ⊕ that are not associative, or round), held
    bitwise to their plain version (the JAX join's lanes through
    segops.segmented_scan) and to a second launch: mxm(X, Y, mask L,
    transpose_inp1) at rmat18's L with seeded values of both signs
    (float32 in [-2, 2), int32 in [-3, 3]) for the five semirings on each
    dtype, one ordered launch each and no other kernel, then the same on a
    seeded small graph. Times the GreaterPlus float32 fold beside its plain
    version and computes its bound. Returns the kernels-line row and the
    launches of the rmat18 calls."""
    import numpy as np
    import torch

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.ops import spgemm as sp
    from graphblast_tpu_torch.ops.kernels.masked_intersect import (
        masked_intersect_fold, masked_intersect_fold_plain)

    def copies(M, seed):
        r, c, _ = M.extract_tuples()
        g = torch.Generator().manual_seed(seed)
        m, n = len(r), M.nrows
        out = {}
        for dtype in (torch.float32, torch.int32):
            pair = []
            for k in range(2):
                v = (torch.rand(m, generator=g) * 4 - 2 if dtype
                     == torch.float32 else torch.randint(-3, 4, (m,),
                                                         generator=g))
                pair.append(gt.Matrix.from_coo(r, c, v.to(dtype).numpy(), n,
                                               n, dtype=dtype,
                                               device="cuda"))
            out[dtype] = pair
        return out

    def check(tag, M, graphs):
        launches = 0
        for dtype, (X, Y) in graphs.items():
            for name in ORDERED_SEMIRINGS:
                sr = getattr(gt.semiring, f"{name}Semiring")
                _reset_counts()
                C = gt.mxm(X, Y, sr, mask=M,
                           desc=gt.Descriptor(transpose_inp1=True))
                launches += _expect_launches(
                    f"{tag} {name}", {"masked_intersect_fold_ordered": 1})[
                        "masked_intersect_fold_ordered"]
                ops = sp._operands(X, Y, M, True)
                c = C.val[: M.nvals]
                again = masked_intersect_fold(*ops, sr)
                want = masked_intersect_fold_plain(*ops, sr)
                if not (torch.equal(c.view(torch.int32),
                                    want.view(torch.int32))
                        and torch.equal(c.view(torch.int32),
                                        again.view(torch.int32))):
                    bad = int((c.view(torch.int32)
                               != want.view(torch.int32)).sum())
                    raise AssertionError(f"T2 ordered {tag} {name} {dtype}: "
                                         f"{bad} values != plain, or a "
                                         "second launch differs")
        print(f"[T2 ordered] {tag}: {', '.join(ORDERED_SEMIRINGS)} on "
              f"float32 and int32, each one ordered launch, bitwise equal "
              f"to its plain version and a second launch")
        return launches

    graphs = copies(L, 42)
    launches = check("rmat18's L", L, graphs)
    X, Y = graphs[torch.float32]
    sr = gt.semiring.GreaterPlusSemiring
    ops = sp._operands(X, Y, L, True)
    fold = lambda: masked_intersect_fold(*ops, sr)  # noqa: E731
    ms = _event_ms(fold, reps)
    plain_ms = _event_ms(lambda: masked_intersect_fold_plain(*ops, sr), 2)
    m = L.nvals
    # bytes once: the mask ids, A's and B's pointers, ids and values, c
    bound_bytes = 8 * m + 2 * (4 * (L.nrows + 1) + 8 * m) + 4 * m
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    mi, mj, a_ptr, _, _, b_ptr, _, _ = ops
    walked = int(torch.minimum(a_ptr[mi.long() + 1] - a_ptr[mi.long()],
                               b_ptr[mj.long() + 1] - b_ptr[mj.long()])
                 .sum())
    print(f"[T2 ordered] GreaterPlus float32 at rmat18's L ({m} mask "
          f"edges, {walked} lanes): kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {bound_bytes} B -> {bound_ms:.6f} ms "
          f"at 3.35 TB/s; no PyTorch call folds a masked product under a "
          f"comparison ⊕")
    del graphs, X, Y, ops
    # a seeded small graph with 4 hub rows, whose walks take both sides
    rng = np.random.default_rng(7)
    n = 2000
    r = rng.integers(0, n, 40_000)
    r[:10_000] = rng.integers(0, 4, 10_000)
    key = np.unique(r * n + rng.integers(0, n, 40_000))
    S = gt.Matrix.from_coo(key // n, key % n, np.ones(len(key), np.float32),
                           n, n, device="cuda")
    check("a seeded 2,000-vertex graph", S, copies(S, 7))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=None), launches



def _random_csr(n: int, deg: int, seed: int, device: str = "cuda"):
    """A seeded uniform random CSR made on `device`: n rows and columns,
    `deg` edges a row, standard-normal values; and a standard-normal x."""
    import torch

    from graphblast_tpu_torch.ops.kernels.value_pull import build_plan

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ptr = torch.arange(0, n * deg + 1, deg, dtype=torch.int32, device=device)
    ind = torch.randint(0, n, (n * deg,), generator=g, dtype=torch.int32,
                        device=device)
    val = torch.randn(n * deg, generator=g, device=device)
    x = torch.randn(n, generator=g, device=device)
    return build_plan(ptr, ind, val, n, n), x


def phase_big_graphs():
    """Phases 37-40 in one temporary directory (RMAT 20 and 22's cache
    files, the .mtx), removed at the end: the cache tool, bfs22 and
    spmv22, mtx at RMAT 20, tc20. Returns phase_rmat22's values and
    phase_tc20's."""
    with tempfile.TemporaryDirectory() as cache_dir:
        t0 = time.perf_counter()
        phase_rmat_cache(cache_dir)
        print(f"[phase] RMAT 20 and 22 cache {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        rmat22 = phase_rmat22(cache_dir)
        print(f"[phase] bfs22 and spmv22 {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase_mtx20(cache_dir)
        print(f"[phase] mtx at rmat20 {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        tc20 = phase_tc20(cache_dir)
        print(f"[phase] tc20 {time.perf_counter() - t0:.2f} s")
    return (*rmat22, *tc20)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    import graphblast_tpu_torch  # noqa: F401  (fails alone in a directory)
    from graphblast_tpu_torch.algorithms.reference import bfs_cpu
    from graphblast_tpu_torch.io.rmat import rmat_matrix
    from graphblast_tpu_torch.ops.kernels.value_pull import plan_for

    t0 = time.perf_counter()
    phase_device_and_build()
    print(f"[phase] device and build {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    A = rmat_matrix(18, 16, seed=42, device="cuda")
    print(f"[graph] rmat18: n={A.nrows} nnz={A.nvals} symmetric="
          f"{A.symmetric} built in {time.perf_counter() - t0:.2f} s")
    if (A.nrows, A.nvals) != (RMAT18_N, RMAT18_NNZ):
        raise AssertionError("rmat18 differs from the recorded graph")
    deg = np.diff(A.host_csr()[0])
    sources = np.argsort(deg)[::-1][:8].astype(np.int64)
    goldens = [bfs_cpu(A, int(s)) for s in sources]

    print(f"[phase] graph and goldens {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    k1, bound_ms = phase_kernel_vs_plain(A, goldens[0], int(sources[0]))
    print(f"[phase] K1 vs plain {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches, per_s, iters = phase_main_path(A, sources, goldens)

    main_row = k1["hub_level2"]
    k1_ms = iters[0] * main_row["ms"]
    print(f"[bfs] K1 time per run ({iters[0]} launches x "
          f"{main_row['ms']:.6f} ms) = {k1_ms:.6f} ms, "
          f"{100 * k1_ms / (per_s * 1e3):.2f}% of the median run")
    print(f"[phase] BFS {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.ncols).astype(np.float32)).cuda()
    k2 = phase_value_pull("K2 rmat18", plan_for(A), x, plain_reps=20)
    print(f"[phase] value pull at rmat18 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    pr_launches, pr_golden = phase_pagerank(A)
    print(f"[phase] PageRank {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k4 = phase_monoid_pull(A)
    print(f"[phase] K4 vs plain at rmat18 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sssp_launches, unbound_launches, sssp_goldens, sssp_per_s = phase_sssp(
        A, sources, k4["min_plus_masked"]["ms"])
    print(f"[phase] SSSP {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cc_launches, cc_golden, cc_per_s = phase_cc(
        A, k4["min_select_second"]["ms"])
    print(f"[phase] CC {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k6 = phase_gather(A)
    print(f"[phase] K6 vs plain at rmat18 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k5 = phase_orpull(A, goldens[0])
    print(f"[phase] K5 vs plain at rmat18 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    s_rows = phase_minmax_pull(A)
    print(f"[phase] S vs plain at rmat18 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    stepped_counts, _ = phase_stepped_bfs(A, sources, goldens)
    print(f"[phase] stepped BFS {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    mis_counts, _, _ = phase_mis(A)
    print(f"[phase] MIS {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_gc(A)
    print(f"[phase] GC {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cc_s_counts = phase_cc_plan_less(A, cc_golden, cc_per_s)
    print(f"[phase] plan-less CC {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    tc_launches, fold_launches, t1_row, t2_row, L18 = phase_tc(A)
    print(f"[phase] TC and the masked mxm {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_tc_past_budget()
    print(f"[phase] TC past the shared-memory budget "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bitmap_launches, push_per_s, gather_push, p_row = phase_push_bfs(
        A, sources, goldens)
    print(f"[push bfs] median ms/run push-only {push_per_s * 1e3:.6f}, "
          f"pull-only (phase 3) {per_s * 1e3:.6f}")
    print(f"[phase] push BFS {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    push_sssp_per_s = phase_push_sssp(A, sources, sssp_goldens)
    print(f"[push sssp] median ms/run push-only {push_sssp_per_s * 1e3:.6f},"
          f" pull-only (phase 7) {sssp_per_s * 1e3:.6f}")
    print(f"[phase] push SSSP {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    one_way_s, G, grid_golden = phase_push_grid()
    print(f"[phase] grid BFS push and pull {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_pushpull_bfs(A, sources, goldens, per_s, push_per_s)
    print(f"[phase] PUSHPULL BFS {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_pushpull_sssp(A, sources, sssp_goldens, sssp_per_s,
                        push_sssp_per_s)
    print(f"[phase] PUSHPULL SSSP {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_pushpull_grid(G, grid_golden, one_way_s)
    del G
    print(f"[phase] grid BFS PUSHPULL {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_valued_bfs(A, int(sources[0]), goldens[0])
    print(f"[phase] valued BFS {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_diameter(A)
    print(f"[phase] diameter {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_gbfs_driver()
    print(f"[phase] gbfs driver {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_cc_2_24()
    print(f"[phase] CC at 2^24 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    plan, x = _random_csr(1 << 24, 8, seed=42)
    k3 = phase_value_pull("K3 regime 2^24", plan, x, plain_reps=5)
    del plan, x
    print(f"[phase] value pull at 2^24 rows {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    api_counts, k5_mxv, s_mxv = phase_api(A)
    print(f"[phase] operations surface at rmat18 "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lgc_counts, k6_lgc, lgc_golden = phase_lgc(A, int(sources[0]))
    phase_glgc_driver()
    print(f"[phase] LGC and the glgc driver {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    esc_counts, k6_esc = phase_spgemm()
    print(f"[phase] unmasked SpGEMM {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_mxm_dense(A)
    print(f"[phase] mxm_dense at rmat18 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_drivers()
    print(f"[phase] the six drivers {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_native_ingest(A.nvals)
    print(f"[phase] native ingest {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dist_rows = phase_dist(A, sources, goldens, sssp_goldens, cc_golden,
                           pr_golden, lgc_golden)
    print(f"[phase] distributed at world size 1 "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dist_rows.update(phase_dist_second_half(A, sources, goldens, pr_golden,
                                    t1_row["library_ms"]))
    del A
    print(f"[phase] distributed, second half, at world size 1 "
          f"{time.perf_counter() - t0:.2f} s")
    (k1_22, k1_22_bound, bfs22_launches, k2_22, k2_22_launches, t1_20,
     tc20_launches) = phase_big_graphs()
    t0 = time.perf_counter()
    ordered_row, ordered_launches = phase_ordered_folds(L18)
    del L18
    print(f"[phase] T2's ordered folds {time.perf_counter() - t0:.2f} s")

    kernels = [{
        "name": "bitmap_pull",
        "route": "cuda",
        "source": "graphblast_tpu_torch/csrc/bitmap_pull.cu",
        "replaces": "graphblast_tpu/ops/pallas/bilinear.py:873",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
    }]
    # one kernel serves both TPU call sites; `launches` is its count in the
    # PageRank run, which at rmat18 is K2's call site
    for name, replaces, row in (
            ("value_pull", "graphblast_tpu/ops/pallas/bilinear.py:305", k2),
            ("value_pull_beyond_l2",
             "graphblast_tpu/ops/pallas/bilinear.py:1287", k3)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "graphblast_tpu_torch/csrc/value_pull.cu",
            "replaces": replaces, "launches": pr_launches,
            "bound_by": "bytes", **row})
    # one kernel, two call sites of the main paths: SSSP's, through the
    # masked entry, and CC's; launches: each row's on its path (SSSP's
    # MinimumPlus pulls unbound are those that missed the masked entry)
    for name, launches in (("min_plus", unbound_launches),
                           ("min_plus_masked", sssp_launches),
                           ("min_select_second", cc_launches)):
        kernels.append({
            "name": f"monoid_pull_{name}", "route": "cuda",
            "source": "graphblast_tpu_torch/csrc/monoid_pull.cu",
            "replaces": "graphblast_tpu/ops/pallas/monopull.py:172",
            "launches": launches, "bound_by": "bytes", **k4[name]})
    kernels.append({
        "name": "orpull_csum", "route": "cuda",
        "source": "graphblast_tpu_torch/csrc/orpull_csum.cu",
        "replaces": "graphblast_tpu/ops/pallas/orpull.py:49",
        "launches": stepped_counts["orpull_csum"], "bound_by": "bytes",
        **k5["hub_level2"],
        "max_abs_err": max(r["max_abs_err"] for r in k5.values())})
    # one kernel, two call sites of the main paths: MIS's max pull and
    # plan-less CC's select-second pull; it replaces plain jnp, no Pallas
    for name, row, launches in (
            ("max_times", s_rows["max_times"], mis_counts["minmax_pull"]),
            ("min_second", s_rows["min_second"],
             cc_s_counts["minmax_pull"])):
        kernels.append({
            "name": f"minmax_pull_{name}", "route": "cuda",
            "source": "graphblast_tpu_torch/csrc/minmax_pull.cu",
            "replaces": "graphblast_tpu/ops/segops.py:35",
            "launches": launches, "bound_by": "bytes", **row})
    # one kernel serves both TPU gathers; an entry for each call-site class
    # of the port's paths, with that class's count on the path it lies on.
    # The packed-words class (gather_1d_small's) has no call site in the
    # port, so phase 9's timing of it stays out of this line.
    for name, launches in (("x", mis_counts["gather_x"]),
                           ("boundary", stepped_counts["gather_boundary"])):
        kernels.append({
            "name": f"gather_{name}", "route": "cuda",
            "source": "graphblast_tpu_torch/csrc/gather.cu",
            "replaces": "graphblast_tpu/ops/pallas/gather.py:45",
            "launches": launches, "bound_by": "bytes", **k6[name]})
    # K6 at the sort push's largest gather (ind at the expansion's edge
    # ids); launches: every K6 launch of the push SSSP, all at ascending
    # indices (a BFS push launches none)
    kernels.append({
        "name": "gather_push", "route": "cuda",
        "source": "graphblast_tpu_torch/csrc/gather.cu",
        "replaces": "graphblast_tpu/ops/pallas/gather.py:45",
        "launches": phase_push_sssp.k6, "bound_by": "bytes", **gather_push})
    # P, the bitmap push, at the hub's level-2 frontier; launches: the push
    # BFS's, one an iteration. No PyTorch call computes the push: the sort
    # push it replaces on this route is timed beside it
    kernels.append({
        "name": "bitmap_push", "route": "cuda",
        "source": "graphblast_tpu_torch/csrc/bitmap_push.cu",
        "replaces": "none (the jnp push of graphblast_tpu/ops/spmspv.py)",
        "launches": bitmap_launches, "bound_by": "bytes", **p_row})
    # T1 and T2: one kernel file in place of plain jnp, no Pallas
    for name, replaces, launches, row in (
            ("masked_intersect_count", "graphblast_tpu/ops/spgemm.py:159",
             tc_launches, t1_row),
            ("masked_intersect_fold", "graphblast_tpu/ops/spgemm.py:70",
             fold_launches, t2_row)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "graphblast_tpu_torch/csrc/masked_intersect.cu",
            "replaces": replaces, "launches": launches, "bound_by": "bytes",
            **row})
    # the call sites of the operations surface, LGC and the ESC (phases
    # 29-31), each with its launches in its own phase's counted run
    for name, route_src, replaces, launches, row in (
            ("orpull_csum_mxv", "orpull_csum.cu",
             "graphblast_tpu/ops/pallas/orpull.py:49",
             api_counts["orpull_csum"], k5_mxv),
            ("minmax_pull_mxv", "minmax_pull.cu",
             "graphblast_tpu/ops/segops.py:35",
             api_counts["minmax_pull"], s_mxv),
            ("gather_lgc", "gather.cu",
             "graphblast_tpu/ops/pallas/gather.py:45",
             lgc_counts["gather_x"] + lgc_counts["gather_boundary"],
             k6_lgc),
            ("gather_esc", "gather.cu",
             "graphblast_tpu/ops/pallas/gather.py:45",
             esc_counts["gather_boundary"], k6_esc)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"graphblast_tpu_torch/csrc/{route_src}",
            "replaces": replaces, "launches": launches, "bound_by": "bytes",
            **row})
    # the distributed layer's call sites (phases 35 and 36), each with its
    # launches in that phase's counted runs: K1 in bfs_dist's pulls, the
    # value pull in pr_dist's, S in sssp_dist's and cc_dist's, K6 in the
    # ring PageRank's stages, T1 in tc_dist's
    for name, route_src, replaces in (
            ("bitmap_pull_dist", "bitmap_pull.cu",
             "graphblast_tpu/ops/pallas/bilinear.py:873"),
            ("value_pull_dist", "value_pull.cu",
             "graphblast_tpu/ops/pallas/bilinear.py:1287"),
            ("minmax_pull_dist", "minmax_pull.cu",
             "graphblast_tpu/ops/segops.py:35"),
            ("gather_ring", "gather.cu",
             "graphblast_tpu/ops/pallas/gather.py:45"),
            ("masked_intersect_count_dist", "masked_intersect.cu",
             "graphblast_tpu/ops/spgemm.py:159")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"graphblast_tpu_torch/csrc/{route_src}",
            "replaces": replaces, "bound_by": "bytes", **dist_rows[name]})
    # the larger stages (phases 38 and 40): K1 in bfs22's pulls, the value
    # pull in spmv22's mxv_dual calls, T1 in tc20's calls, and T2's ordered
    # fold in the masked mxm calls at rmat18's L
    for name, route_src, replaces, launches, row in (
            ("bitmap_pull_rmat22", "bitmap_pull.cu",
             "graphblast_tpu/ops/pallas/bilinear.py:873", bfs22_launches,
             dict(k1_22, bound_ms=k1_22_bound)),
            ("value_pull_rmat22", "value_pull.cu",
             "graphblast_tpu/ops/pallas/bilinear.py:1287", k2_22_launches,
             k2_22),
            ("masked_intersect_count_rmat20", "masked_intersect.cu",
             "graphblast_tpu/ops/spgemm.py:159", tc20_launches, t1_20),
            ("masked_intersect_fold_ordered", "masked_intersect.cu",
             "graphblast_tpu/ops/spgemm.py:70", ordered_launches,
             ordered_row)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"graphblast_tpu_torch/csrc/{route_src}",
            "replaces": replaces, "launches": launches, "bound_by": "bytes",
            **row})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main_tc_classes() if sys.argv[1:] == ["--tc-classes"]
             else main())
