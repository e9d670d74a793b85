"""Shared helpers of the ``test_torch_*`` parity tests.

The same inputs, made with numpy from a seed, go through the JAX package
(``repro``, the reference, on the CPU with its Pallas kernels in interpret
mode) and through the PyTorch port (``repro_torch``, on ``device="cpu"``, where
its ops run the kernels' plain versions).  Only the tests import both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import repro.core as ref_core
from repro_torch import convert


def complex_signal(seed: int, *shape: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fpm_arrays(n: int, p: int = 3, *, hetero: bool = True, seed: int = 0):
    """Seeded random speed functions as plain arrays
    ``[(xs, ys, speed, name), ...]``: a smooth base surface times a random
    per-point factor (non-monotonic, as measured profiles are), scaled per
    processor when ``hetero``."""
    rng = np.random.default_rng(seed)
    xs = np.array(sorted({1, max(n // 8, 1), max(n // 4, 1), max(n // 2, 1), n}))
    ys = np.array(sorted({n // 2, n, n + n // 8, n + n // 4, 2 * n}))
    base = np.outer(xs, np.log2(np.maximum(ys, 2))) + 3.0
    out = []
    for i in range(p):
        if hetero or i == 0:
            speed = base * rng.uniform(0.6, 1.6, size=base.shape) * (i + 1.0)
        else:
            speed = out[0][2].copy()
        out.append((xs, ys, speed, f"P{i}"))
    return out


def both_fpms(n: int, p: int = 3, *, hetero: bool = True, seed: int = 0):
    """(reference FPMSet, port FPMSet) from the same arrays."""
    arrays = fpm_arrays(n, p, hetero=hetero, seed=seed)
    ref = ref_core.FPMSet([ref_core.SpeedFunction(xs, ys, sp, name=name)
                           for xs, ys, sp, name in arrays])
    return ref, convert.fpms_from_arrays(arrays)


def padding_fpm_arrays(n: int):
    """One slow/flat and two fast processors whose speed peaks at 2N, so that
    the FPM-chosen pad of the fast ones is 2N > N and the pad semantics of
    PFFT-FPM-PAD really engage (a power-of-two pad when N is one)."""
    xs = np.array(sorted({1, n // 2, n}))
    ys = np.array(sorted({n, 2 * n, 4 * n}))
    fast = np.tile([1e9, 4e9, 1e9], (len(xs), 1))
    slow = np.full((len(xs), len(ys)), 2.5e8)
    return [(xs, ys, slow if i == 0 else fast, f"P{i}") for i in range(3)]


def both_padding_fpms(n: int):
    arrays = padding_fpm_arrays(n)
    ref = ref_core.FPMSet([ref_core.SpeedFunction(xs, ys, sp, name=name)
                           for xs, ys, sp, name in arrays])
    return ref, convert.fpms_from_arrays(arrays)


def _pad(f):
    """Padded index of element f of a register-resident kernel's exchange
    buffer (``csrc/regfft.cuh``: one float2 of padding per 16)."""
    return f + (f >> 4)


def kernel_pass_model(z: torch.Tensor, plan, *, inverse: bool = False):
    """A register-resident kernel's passes (``csrc/regfft.cuh``) in float64,
    thread by thread, on the rows of ``z`` (complex rows, or packed real
    pairs), in the launch shape ``plan`` = ``(rows_per_cta, threads, points,
    radices, smem_bytes)`` of ``complex_rows_plan``:
    thread t of a row's group holds x[t + k*T] in its registers, runs
    ``points / r`` butterflies of radix r (butterfly b takes slots
    b + u*(points/r)), twiddles and writes slot u to y[(j*r + u)*s + q];
    ``inverse`` flips the sign and scales by 1/n.  Returns the transform and,
    per exchange access of every thread of a CTA of ``rows_per_cta`` rows,
    the worst number of a half-warp's 16 threads that hit one shared-memory
    bank."""
    rows, n = z.shape
    per_cta, _, points, radices, smem = plan
    sign = 1.0 if inverse else -1.0
    group = n // points
    t = torch.arange(group)
    mine = t[:, None] + torch.arange(points)[None, :] * group    # (T, points)
    x = z.to(torch.complex128)
    accesses = [mine[:, k] for k in range(points)]
    log2s = 0
    for pass_, r in enumerate(radices):
        b = points // r
        u = torch.arange(r)
        dft = torch.exp(sign * 2j * math.pi * torch.outer(u, u).double() / r)
        y = torch.einsum("uv,ptvb->ptub", dft, x[:, mine].reshape(rows, group, r, b))
        i = t[:, None] + torch.arange(b)[None, :] * group        # butterflies
        s, ncur = 1 << log2s, n >> log2s
        j, q = i >> log2s, i & (s - 1)
        y = y * torch.exp(sign * 2j * math.pi
                          * (j[:, None, :] * u[None, :, None]).double() / ncur)
        dest = ((j[:, None, :] * r + u[None, :, None]) << log2s) + q[:, None, :]
        assert sorted(dest.flatten().tolist()) == list(range(n))
        if pass_ < len(radices) - 1:
            accesses += [dest[:, uu, bb] for uu in range(r) for bb in range(b)]
        else:  # the last pass leaves natural order: its slots are its reads
            assert torch.equal(dest.reshape(group, points), mine)
        x = torch.empty_like(x)
        x[:, dest.flatten()] = y.reshape(rows, -1)
        log2s += r.bit_length() - 1
    worst = 1
    for a in accesses:  # every thread of a CTA, row by row
        f = (torch.arange(per_cta)[:, None] * n + a[None, :]).flatten()
        assert int(_pad(f).max()) < smem // 8
        for h in range(0, f.numel(), 16):
            banks = (_pad(f[h:h + 16]) % 16).tolist()
            worst = max(worst, max(banks.count(v) for v in banks))
    return (x / n if inverse else x), worst


def k4_swizzle(n: int, per_cta: int) -> tuple[int, int, int]:
    """The XOR swizzle of K4's Z buffer (``csrc/rfft_rows_transpose.cu``,
    ``Swizzle``): bin k of the CTA's pair p goes to slot ``f ^ h(f >> 4)``,
    f = k*P + p, P = ``per_cta``.  h moves the bits of the 16-slot block
    number m = f >> 4 that vary across a half-warp's writes (the bins of a
    thread's neighbours) into the bank bits that are fixed there, and leaves
    the bits at and above log2 P alone, so that the store's reads, 16
    consecutive f or a run across two blocks, stay conflict-free.  Returns
    ``(s, bits, shift)`` with h(m) = ((m >> s) & (2**bits - 1)) << shift."""
    group = n // min(16, n)
    lanes_k = min(group.bit_length() - 1, 4)   # bits of k a half-warp's writes vary
    lp = per_cta.bit_length() - 1
    if lp >= 4:
        return lp - 4, lanes_k, 4 - lanes_k
    return 0, max(lanes_k + lp - 4, 0), 4 - lanes_k


def k4_slot(f, swizzle):
    s, bits, shift = swizzle
    return f ^ (((f >> 4 >> s) & ((1 << bits) - 1)) << shift)


def _worst_bank_count(slots: np.ndarray, live: np.ndarray) -> int:
    """Worst number of a half-warp's live lanes that hit one bank, over
    ``slots`` of shape (..., 16): a float2 slot is two 4-byte banks, so 16
    slots cover the 32 banks, as in ``kernel_pass_model``."""
    banks = np.where(live, slots % 16, -1)
    return max(1, max(int((banks == b).sum(-1).max(initial=0)) for b in range(16)))


def k4_store_model(z: torch.Tensor, rows: int, plan, *, cluster: int = 1):
    """K4's split and transposed store (``csrc/rfft_rows_transpose.cu``) in
    float64, thread by thread, in its launch shape: ``plan`` is
    ``complex_rows_plan(n, pairs)`` (P pairs per CTA, T threads), ``z`` the
    (pairs, n) transforms of the packed pairs (``kernel_pass_model``'s Z),
    ``rows`` the real row count (odd: the last pair has no b).

    Each CTA writes its pairs' Z once to its buffer, bin k of pair p at
    ``k4_slot(k*P + p)``, from the registers of the passes (thread t of
    pair p holds bins t + c*n/16).  The store runs idx over (k, p), p
    fastest, reads Z[k] and Z[(n - k) mod n], and writes A to out[k, a] and
    B to out[k, a + 1], a = 2 * pair, unless a + 1 = rows.  With ``cluster``
    C > 1 (P = 1) CTA rank r of a cluster stores the bins of its slice
    r*S ... r*S + S - 1 (S = ceil((n/2 + 1) / C)) for the C pairs of the
    cluster, idx over (k, q) with q fastest, reading pair q's buffer in CTA
    q.  A CTA with no pair writes zeros to its buffer and stores nothing.

    Returns ``(out, writes, worst_bank, runs)``: the (n//2+1, rows) result;
    how often each element, and the column past the last, was written
    (shape (n//2+1, rows + 1)); the worst bank count per half-warp of the
    buffer's writes and of the store's reads (per target CTA in a cluster);
    and for every warp instruction and output row it writes,
    ``(bytes, contiguous, full)``: the bytes written, whether they form one
    run, and whether the CTA (cluster) that wrote them holds its P (C) pairs,
    each with its b."""
    pairs, n = z.shape
    per_cta, threads, points = plan[:3]
    group = n // points
    nh = n // 2 + 1
    if cluster > 1 and per_cta != 1:
        raise ValueError("the cluster store holds one pair per CTA")
    swz = k4_swizzle(n, per_cta)
    lp = per_cta.bit_length() - 1
    zz = z.to(torch.complex128).numpy()
    out = np.zeros((nh, rows + 1), np.complex128)
    writes = np.zeros((nh, rows + 1), np.int64)
    worst, runs = 1, []
    tid = np.arange(threads)
    p_of, t_of = tid // group, tid % group
    held = t_of[:, None] + np.arange(points)[None, :] * group      # (T, points)
    write_slots = k4_slot((held << lp) + p_of[:, None], swz)
    span = per_cta * cluster                 # pairs one store reaches
    if cluster == 1:
        total, lq, slice_len = per_cta * nh, lp, nh
    else:
        slice_len = -(-nh // cluster)
        total, lq = slice_len * cluster, cluster.bit_length() - 1
    iters = -(-total // threads)
    idx = tid[None, :] + np.arange(iters)[:, None] * threads       # (iters, T)
    for first in range(0, pairs, span):
        bufs = []
        for c in range(cluster):
            buf = np.zeros(per_cta * n, np.complex128)
            for q in range(per_cta):
                if first + c * per_cta + q < pairs:
                    mine = p_of == q
                    buf[write_slots[mine]] = zz[first + c * per_cta + q][held[mine]]
            bufs.append(buf)
        hw = write_slots.T.reshape(points, -1, 16)
        worst = max(worst, _worst_bank_count(hw, np.ones(hw.shape, bool)))
        full = first + span <= pairs and 2 * (first + span) <= rows
        for rank in range(cluster):
            k = rank * slice_len + (idx >> lq)
            q = idx & ((1 << lq) - 1)
            live = (idx < total) & (k < nh)
            kr = (n - k) & (n - 1)
            if cluster == 1:
                src = np.zeros_like(q)
                s1, s2 = k4_slot((k << lp) + q, swz), k4_slot((kr << lp) + q, swz)
            else:
                src, s1, s2 = q, k, kr
            zk = np.zeros(idx.shape, np.complex128)
            zr = np.zeros(idx.shape, np.complex128)
            for target, buf in enumerate(bufs):
                sel = live & (src == target)
                for s in (s1, s2):
                    worst = max(worst, _worst_bank_count(
                        s.reshape(iters, -1, 16), sel.reshape(iters, -1, 16)))
                zk[sel], zr[sel] = buf[s1[sel]], buf[s2[sel]]
            spec = (0.5 * (zk.real + zr.real) + 0.5j * (zk.imag - zr.imag),
                    0.5 * (zk.imag + zr.imag) + 0.5j * (zr.real - zk.real))
            a = 2 * (first + q)
            store = live & (first + q < pairs)
            stores = (store, store & (a + 1 < rows))
            for half in (0, 1):
                m = stores[half]
                np.add.at(writes, (k[m], a[m] + half), 1)
                out[k[m], a[m] + half] = spec[half][m]
            # Per (warp instruction, output row): the element columns written.
            keys, cols = [], []
            for half in (0, 1):
                it, lane = np.nonzero(stores[half])
                keys.append(np.stack([it, lane // 32, k[it, lane]], 1))
                cols.append(a[it, lane] + half)
            keys, cols = np.concatenate(keys), np.concatenate(cols)
            uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
            inverse = inverse.reshape(-1)
            lo = np.full(len(uniq), np.iinfo(np.int64).max)
            hi = np.full(len(uniq), -1)
            count = np.bincount(inverse, minlength=len(uniq))
            np.minimum.at(lo, inverse, cols)
            np.maximum.at(hi, inverse, cols)
            runs += [(8 * int(c), bool(h - l + 1 == c), full)
                     for c, l, h in zip(count, lo, hi)]
    return out[:, :rows], writes, worst, runs


def k2_store_model(z, rows: int, plan, *, cluster: int = 1):
    """K2's transposed store (``csrc/fft_rows_transpose.cu``) in float64,
    thread by thread, in its launch shape: ``plan`` is
    ``complex_rows_plan(n, rows)`` (P rows per CTA, T threads), ``z`` the
    (rows, n) row transforms (``kernel_pass_model``'s Z), or None for the
    pattern alone.

    Each CTA writes its rows' Z once to its buffer, bin k of row p at
    ``k4_slot(k*P + p)``, from the registers of the passes (thread t of row
    p holds bins t + c*n/16).  The C = ``cluster`` CTAs of a cluster (C = 1:
    a CTA alone) then store their W = C*P rows side by side: CTA rank r
    stores bins r*S ... r*S + S - 1 (S = n/C) of all of them, idx =
    (k - r*S)*W + q with q fastest, reading row q from the buffer of CTA
    q // P at ``k4_slot(k*P + q % P)``, and writes out[k, row0 + q] unless
    row0 + q >= rows.  A CTA with no row writes zeros to its buffer and
    stores nothing.

    Returns ``(out, writes, worst_bank, runs)``: the (n, rows) result (None
    without ``z``); how often each element, and the column past the last,
    was written (shape (n, rows + 1)); the worst bank count per half-warp of
    the buffer's writes and of the store's reads (per target CTA); and for
    every warp instruction and output row it writes, as three arrays, the
    bytes written, whether they form one run, and whether the cluster (the
    CTA) that wrote them holds all its W rows."""
    per_cta, threads, points = plan[:3]
    n = points * (threads // per_cta)
    group = n // points
    swz = k4_swizzle(n, per_cta)
    lp = per_cta.bit_length() - 1
    wide = per_cta * cluster                  # rows one store reaches
    lw = wide.bit_length() - 1
    slice_len = n // cluster
    tid = np.arange(threads)
    p_of, t_of = tid // group, tid % group
    held = t_of[:, None] + np.arange(points)[None, :] * group      # (T, points)
    write_slots = k4_slot((held << lp) + p_of[:, None], swz)
    assert np.unique(write_slots).size == write_slots.size
    assert write_slots.max() < per_cta * n
    hw = write_slots.T.reshape(points, -1, 16)
    worst = _worst_bank_count(hw, np.ones(hw.shape, bool))
    # The store: step c of thread t is idx = t + c*T (C, R, T) of each rank.
    idx = tid[None, :] + np.arange(points)[:, None] * threads
    q = np.broadcast_to(idx & (wide - 1), (cluster,) + idx.shape)
    k = np.arange(cluster)[:, None, None] * slice_len + (idx >> lw)
    src = q >> lp
    read_slots = k4_slot((k << lp) + (q & (per_cta - 1)), swz)
    for target in range(cluster):
        worst = max(worst, _worst_bank_count(read_slots.reshape(-1, 16),
                                             (src == target).reshape(-1, 16)))
    # Each warp instruction (rank, c, warp) and output row k is a run; lanes
    # of one run differ in q only.
    run_of = ((np.arange(cluster)[:, None, None] * points
               + np.arange(points)[None, :, None]) * (threads // 32)
              + tid[None, None, :] // 32) * n + k
    span = cluster * points * (threads // 32) * n             # run keys a cluster
    zz = None if z is None else z.to(torch.complex128).numpy()
    out = None if zz is None else np.zeros((n, rows + 1), np.complex128)
    writes = np.zeros((n, rows + 1), np.int32)
    runs = ([], [], [])
    clusters = -(-rows // wide)
    chunk = max(1, (1 << 21) // (wide * n))
    for c0 in range(0, clusters, chunk):
        firsts = np.arange(c0, min(c0 + chunk, clusters))[:, None, None, None] * wide
        row = firsts + q                                             # (B, C, R, T)
        live = row < rows
        if zz is not None:
            rows_here = np.arange(firsts.size * wide) + c0 * wide
            zc = np.zeros((rows_here.size, n), np.complex128)
            zc[rows_here < rows] = zz[rows_here[rows_here < rows]]
            zc = zc.reshape(firsts.size, cluster, per_cta, n)
            buf = np.zeros((firsts.size, cluster, per_cta * n), np.complex128)
            buf[:, :, write_slots] = zc[:, :, p_of[:, None], held]
            value = buf[np.arange(firsts.size)[:, None, None, None], src, read_slots]
            out[np.broadcast_to(k, row.shape)[live], row[live]] = value[live]
        np.add.at(writes, (np.broadcast_to(k, row.shape)[live], row[live]), 1)
        # In memory order the run keys do not decrease (k grows with the
        # lane), so each run is one stretch of the live lanes.
        keys = (np.arange(firsts.size)[:, None, None, None] * span + run_of)[live]
        cols = row[live]
        assert (np.diff(keys) >= 0).all()
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        count = np.diff(np.r_[starts, keys.size])
        lo = np.minimum.reduceat(cols, starts)
        hi = np.maximum.reduceat(cols, starts)
        runs[0].append(8 * count)
        runs[1].append(hi - lo + 1 == count)
        runs[2].append((firsts.reshape(-1) + wide <= rows)[keys[starts] // span])
    runs = tuple(np.concatenate(part) for part in runs)
    return (None if out is None else out[:, :rows]), writes, worst, runs


def _warp_sectors_whole(addr: np.ndarray) -> bool:
    """Whether every warp instruction of ``addr`` (..., T) in complex64
    elements, T a multiple of 32, touches whole 32-byte sectors (4
    elements) only: each sector it touches, it touches whole."""
    lanes = np.sort(addr.reshape(-1, 32), axis=1)
    sector = lanes // 4
    count = np.zeros(lanes.shape, np.int64)
    for i in range(32):
        count[:, i] = (sector == sector[:, i:i + 1]).sum(1)
    distinct = (np.diff(lanes, axis=1) != 0).all()
    return bool(distinct and (count == 4).all())


def _half_warp_banks(slots: np.ndarray) -> int:
    """Worst number of a half-warp's lanes on one bank over ``slots`` (...,
    T) of float2 slots (16 a row of 32 banks)."""
    halves = slots.reshape(-1, 16)
    return _worst_bank_count(halves, np.ones(halves.shape, bool))


def _cluster_model(x, n: int, plan, *, rows: int | None, transposed: bool,
                   out_stride: int | None, inverse: bool):
    """The one-pass kernel over a thread-block cluster
    (``csrc/fourstep_cluster.cuh``'s ``cluster_kernel``) in float64, thread
    by thread, in the launch shape ``plan = (n1, n2, ctas, per, threads,
    smem)``: ``x`` the (rows, n) complex rows, or None for the pattern alone
    (then ``rows``).

    Cluster q holds rows s = q*R + g, g < R = ``per``; rank r runs R*T
    threads, T = n/(16C), thread g*T + i on row g with its part of the
    buffer at g*E, E = (n/C)*17/16 (G1 = n1/16, G2 = n2/16, COLS = n2/C, W =
    n1/C):
    - Column phase: thread i = t*COLS + c loads A[t + k*G1][j2], j2 = r*COLS
      + c, k < 16, from x[s*n + (t + k*G1)*n2 + j2] (zeros where s >= rows);
      the column DFT's exchanges (regfft's passes) put element f of column c
      at g*E + f*COLS + c; then Y[k1][j2] times the exact twiddle
      w_n^(k1*j2), k1 = t + k*G1.
    - Exchange: point k goes to rank k // (16/C), slot g*E + rho*n2 + j2,
      rho = t + (k % (16/C))*G1.
    - Row phase: thread i = rho*G2 + t2 loads slot g*E + rho*n2 + t2 + k*G2
      of its own CTA, B[r*W + rho][t2 + k*G2], and runs the length-n2 DFT.
    - Store: bin k2 = t2 + k*G2 of row rho of row g to slot ``k4_slot((k2*W
      + rho)*R + g)`` (tstore.cuh's swizzle for P = W*R rows of n2), read
      back at idx = tid + k*R*T (q = idx % P, gq = q % R, rho = q // R, k2 =
      idx // P) and written to out[(q*R + gq)*n + k2*n1 + r*W + rho] or,
      ``transposed``, to out[(r*W + rho + n1*k2)*out_stride + q*R + gq]
      where that row exists.

    Returns a dict: ``out`` the result, (rows, n) or (n, out_stride) (None
    without ``x``); ``reads`` how often each input element was loaded;
    ``slab_writes`` how often each (cluster, rank, g, slot) of the R*W*n2
    slab slots was written, ``owner_ok`` whether every point went to the
    rank and row that hold its k1, ``slab_reads`` how often the row phase
    loaded each slot; ``writes`` how often each output element was stored;
    ``worst_bank`` the worst count of a half-warp's lanes on one bank over
    the column exchanges, the remote stores, the row phase's loads, and the
    staging's writes and reads; ``loads_whole`` / ``loads_256`` whether
    every warp instruction of the loads touches whole 32-byte sectors / 32
    consecutive elements from a 256-byte boundary; ``stores_whole`` whether
    every warp instruction of the remote stores, and of the output stores
    of the clusters whose R rows all exist, touches whole 32-byte sectors;
    ``store_runs`` the bytes of each run of consecutive output elements a
    warp instruction writes."""
    n1, n2, ctas, per, threads, smem = plan
    rows = x.shape[0] if x is not None else rows
    out_stride = rows if out_stride is None else out_stride
    g1, g2, cols, w, send = n1 // 16, n2 // 16, n2 // ctas, n1 // ctas, 16 // ctas
    row_threads = threads // per
    elems = smem // 8 // per
    log2w, log2r = w.bit_length() - 1, per.bit_length() - 1
    log2p = log2w + log2r
    assert row_threads == cols * g1 == w * g2 and elems >= w * n2 and elems % 16 == 0
    clusters = -(-rows // per)
    tid = np.arange(threads)
    g, i = tid // row_threads, tid % row_threads
    c, t = i % cols, i // cols
    k = np.arange(16)[:, None]                                      # (16, 1)
    q = np.arange(clusters)[:, None, None, None]                    # (Q, 1, 1, 1)
    r = np.arange(ctas)[None, :, None, None]                        # (1, C, 1, 1)
    j2 = r * cols + c                                               # (1, C, 1, T)
    k1 = t + k * g1                                                 # (16, T)
    s = q * per + g                                                 # (Q, 1, 1, T)
    live = np.broadcast_to(s < rows, (clusters, ctas, 16, threads))
    load = np.broadcast_to(s * n + k1 * n2 + j2, live.shape)        # (Q, C, 16, T)
    reads = np.bincount(load[live], minlength=rows * n)
    loads_whole = _warp_sectors_whole(load)
    warps = load.reshape(-1, 32)
    loads_256 = bool((np.diff(warps, axis=1) == 1).all() and (warps[:, 0] % 32 == 0).all())
    worst = 1
    # The column DFT's exchanges, pass by pass (regfft's radix16_passes).
    log2n1 = n1.bit_length() - 1
    for p in range(log2n1 // 4 - (log2n1 % 4 == 0)):
        log2s = 4 * p
        jj, qq = t >> log2s, t & ((1 << log2s) - 1)
        f = (((jj << 4) << log2s) + qq) + (np.arange(16)[:, None] << log2s)   # (16, T)
        assert np.unique(g * elems + f * cols + c).size == 16 * threads
        worst = max(worst, _half_warp_banks(g * elems + f * cols + c),
                    _half_warp_banks(g * elems + k1 * cols + c))
    # The exchange: owner and slot of every point.
    owner = np.broadcast_to(k // send, k1.shape)
    rho = t + (k % send) * g1
    owner_ok = bool((owner == k1 // w).all() and (rho == k1 % w).all())
    slot = rho * n2 + j2                                             # (1, C, 16, T)
    dest = ((q * ctas + owner) * per + g) * (w * n2) + slot          # (Q, C, 16, T)
    slab_writes = np.bincount(dest.ravel(), minlength=clusters * ctas * per * w * n2)
    remote = np.broadcast_to(g * elems + slot, (1, ctas, 16, threads))
    worst = max(worst, _half_warp_banks(remote))
    remote_whole = _warp_sectors_whole(remote)
    # The row phase's loads.
    rho2, t2 = i // g2, i % g2
    k2 = t2 + k * g2                                                 # (16, T)
    own = rho2 * n2 + k2                                             # (16, T)
    src = ((q * ctas + r) * per + g) * (w * n2) + own                # (Q, C, 16, T)
    slab_reads = np.bincount(src.ravel(), minlength=clusters * ctas * per * w * n2)
    worst = max(worst, _half_warp_banks(g * elems + own))
    # The staging and the store.
    swz = k4_swizzle(n2, w * per)
    put = k4_slot((((k2 << log2w) + rho2) << log2r) + g, swz)
    assert np.unique(put).size == put.size and put.max() < smem // 8
    idx = tid + k * threads                                          # (16, T)
    qq, kk = idx & ((1 << log2p) - 1), idx >> log2p
    gq, rq = qq & (per - 1), qq >> log2r
    get = k4_slot(idx, swz)
    worst = max(worst, _half_warp_banks(put), _half_warp_banks(get))
    col = q * per + gq                                               # (Q, 1, 16, T)
    if transposed:
        store = (r * w + rq + n1 * kk) * out_stride + col            # (Q, C, 16, T)
    else:
        store = col * n + kk * n1 + r * w + rq
    stored = np.broadcast_to(col < rows, store.shape)
    writes = np.bincount(store[stored], minlength=(n * out_stride if transposed
                                                    else rows * n))
    full = clusters if rows % per == 0 else clusters - 1
    stores_whole = remote_whole and (full == 0 or _warp_sectors_whole(store[:full]))
    lanes = store.reshape(-1, 32)
    breaks = np.diff(lanes, axis=1) != 1
    store_runs = []
    for row_breaks in breaks[: min(len(breaks), 4096)]:
        edges = np.flatnonzero(np.r_[True, row_breaks, True])
        store_runs.append(8 * np.diff(edges))
    store_runs = np.concatenate(store_runs)
    out = None
    if x is not None:
        xx = np.concatenate([np.asarray(x, np.complex128).reshape(-1),
                             np.zeros(1, np.complex128)])
        fwd = np.fft.ifft if inverse else np.fft.fft
        sign = 1.0 if inverse else -1.0
        # Column phase: A[c][k1] of each (q, r, g), its DFT, the twiddle;
        # rows past the call load zeros (index rows*n of xx).
        held = xx[np.where(live, load, rows * n)]                    # (Q, C, 16, T)
        colv = np.zeros((clusters, ctas, per, cols, n1), np.complex128)
        gg, cc, kk1 = (np.broadcast_to(a, (16, threads)) for a in (g, c, k1))
        colv[:, :, gg, cc, kk1] = held
        y = fwd(colv, axis=-1)
        jj = np.arange(ctas)[:, None] * cols + np.arange(cols)        # (C, cols)
        y = y * np.exp(sign * 2j * np.pi * ((jj[:, None, :, None] * np.arange(n1)) % n)
                       / n)
        slab = np.zeros(clusters * ctas * per * w * n2, np.complex128)
        slab[dest] = y[:, :, gg, cc, kk1]
        b = np.zeros((clusters, ctas, per, w, n2), np.complex128)
        rr, kk2 = np.broadcast_to(rho2, (16, threads)), np.broadcast_to(k2, (16, threads))
        b[:, :, gg, rr, kk2] = slab[src]
        z = fwd(b, axis=-1)                                          # Z[g][rho][k2]
        staged = np.zeros((clusters, ctas, smem // 8), np.complex128)
        staged[:, :, put] = z[:, :, gg, rr, kk2]
        out = np.zeros(n * out_stride if transposed else rows * n, np.complex128)
        got = np.broadcast_to(staged[:, :, get], store.shape)
        out[store[stored]] = got[stored]
        out = out.reshape((n, out_stride) if transposed else (rows, n))
    return {"out": out, "reads": reads, "slab_writes": slab_writes, "owner_ok": owner_ok,
            "slab_reads": slab_reads, "writes": writes, "worst_bank": worst,
            "loads_whole": loads_whole, "loads_256": loads_256,
            "stores_whole": stores_whole, "store_runs": store_runs}


def k1b_cluster_model(x, n: int, *, rows: int | None = None, inverse: bool = False,
                      ctas: int | None = None):
    """K1b's one-pass kernel (``_cluster_model``, one row a cluster, R = 1)
    in its launch shape ``cluster_plan(n)``, or over ``ctas`` CTAs a cluster
    at the same split (a variant): out[s*n + k2*n1 + r*W + rho], for each k2
    a run of W consecutive elements."""
    from repro_torch.kernels.fft.large import cluster_plan

    n1, n2, rule, threads, smem = cluster_plan(n)
    if ctas is not None and ctas != rule:
        elements = n // ctas
        threads, smem = elements // 16, 8 * (elements + elements // 16)
    return _cluster_model(x, n, (n1, n2, ctas or rule, 1, threads, smem), rows=rows,
                          transposed=False, out_stride=None, inverse=inverse)


def k2b_cluster_model(x, n: int, *, rows: int | None = None,
                      out_stride: int | None = None, inverse: bool = False):
    """K2b's one-pass kernel (``_cluster_model`` with the transposed store,
    as ``csrc/fft_rows_transpose_cluster.cu`` launches it, K2's at n =
    16384) in its launch shape ``transpose_cluster_plan(n)``, stored to an
    (n, ``out_stride``) output (default ``rows``): out[(r*W + rho +
    n1*k2)*out_stride + s], for each (k1, k2) a run of the R rows' s."""
    from repro_torch.kernels.fused.large import transpose_cluster_plan

    return _cluster_model(x, n, transpose_cluster_plan(n), rows=rows, transposed=True,
                          out_stride=out_stride, inverse=inverse)


def _warp_runs(addr: np.ndarray, live: np.ndarray, width: int = 32):
    """Per warp store instruction (``addr`` (..., T) in complex64 elements,
    ``width`` of them an instruction: 32 lanes of one element, or 64 of two;
    ``live`` the elements stored): the bytes of each maximal run of
    consecutive elements, and the instruction's bytes and 32-byte sectors
    touched (instructions that store nothing left out)."""
    none = np.iinfo(np.int64).max
    a = np.sort(np.where(live, addr, none).reshape(-1, width), axis=1)
    valid = a != none
    a, valid = a[valid.any(1)], valid[valid.any(1)]
    start = valid.copy()
    start[:, 1:] &= np.diff(a, axis=1) != 1
    run_id = np.cumsum(start.ravel())[valid.ravel()] - 1
    runs = 8 * np.bincount(run_id) if run_id.size else np.zeros(0, np.int64)
    sector = a // 4
    new_sector = valid.copy()
    new_sector[:, 1:] &= sector[:, 1:] != sector[:, :-1]
    return runs, 8 * valid.sum(1), new_sector.sum(1)


def _half_warp_distinct_banks(slots: np.ndarray) -> int:
    """As ``_half_warp_banks``, counting each distinct slot of a half-warp
    once (lanes that read one slot are served by one broadcast)."""
    halves = np.sort(slots.reshape(-1, 16), axis=1)
    first = np.ones(halves.shape, bool)
    first[:, 1:] = halves[:, 1:] != halves[:, :-1]
    return _worst_bank_count(halves, first)


def _mirror_row(rank, rho, n1: int, h: int):
    """Row k1 of B that local row ``rho`` of cluster rank ``rank`` holds
    under the mirror slots (``Mirror::row`` of ``csrc/rfft_rows_cluster.cuh``):
    r*H + rho on the left (rho < H), its partner n1 - (r*H + rho - H) on the
    right (n1/2 where that slot is 0)."""
    sig = rank * h + rho % h
    return np.where(rho < h, sig, np.where(sig == 0, n1 // 2, n1 - sig))


def _packed_cluster_phases(x, rows: int | None, shape):
    """What the packed cluster kernels share (``packed_cluster_rows`` of
    ``csrc/rfft_rows_cluster.cuh``), in float64, thread by thread, at n =
    16384 in the launch shape ``shape = (n1, C, R)``: n/(16C) threads and
    (n/C)*17/16 complex64 of shared memory a pair; ``x`` the (rows, n) real
    rows, or None for the pattern alone (then ``rows``).

    Cluster q holds pairs p = q*R + g, g < R; rank r runs R*T threads, T =
    n/(16C), thread g*T + i on pair g with its part of the buffer at g*E, E
    = (n/C)*17/16 (G1 = n1/16, G2 = n2/16, COLS = n2/C, W = n1/C, H = W/2):
    - Column phase: thread i = t*COLS + c loads z[(t + k*G1)*n2 + j2] =
      x[2p][.] + i*x[2p + 1][.] (zeros past the call), j2 = r*COLS + c,
      k < 16; the column DFT (exchanges as in ``_cluster_model``) and the
      twiddle w_n^(k1*j2), k1 = t + k*G1.
    - Exchange, mirror slots: slot sigma = k1 (k1 < n1/2), 0 (k1 = n1/2),
      n1 - k1 (above); owner rank sigma // H, local row sigma % H, plus H
      for k1 >= n1/2; point k to slot g*E + local*n2 + j2 of its owner.
    - Row phase: thread i = rho*G2 + t2 loads slot g*E + rho*n2 + t2 + k*G2
      and runs the length-n2 DFT; local row rho of rank r is row
      ``_mirror_row(r, rho)`` of B.

    Returns a dict: the plan's numbers (``n``, ``n1``, ``n2``, ``ctas``,
    ``per``, ``threads``, ``smem``, ``rows``, ``pairs``, ``clusters``, ``w``,
    ``h``, ``elems``) and index arrays (``g``, ``i``, ``rho2``, ``k2``, each
    (16, T) or (T,)); ``reads`` how often each input element was loaded,
    ``loads_128`` whether every warp's load is 32 consecutive floats from a
    128-byte boundary; ``slab_writes`` / ``slab_reads`` how often each
    (cluster, rank, pair, slot) of the slabs was written / loaded;
    ``owner_ok`` whether every row of B went to the local row that
    ``_mirror_row`` maps back to it and both rows of every slot to one rank;
    ``worst_bank`` the worst count of a half-warp's lanes on one bank over
    the column exchanges, the remote stores and the row phase's loads;
    ``remote_whole`` whether every warp's remote store touches whole 32-byte
    sectors; ``z`` (with ``x``) the row phase's output Z[q][r][g][rho][k2]."""
    n = 1 << 14
    n1, ctas, per = shape
    n2, elements = n // n1, n // ctas
    threads, smem = per * elements // 16, 8 * per * (elements + elements // 16)
    rows = x.shape[0] if x is not None else rows
    pairs = (rows + 1) // 2
    g1, g2, cols, w = n1 // 16, n2 // 16, n2 // ctas, n1 // ctas
    h = w // 2
    row_threads = threads // per
    elems = smem // 8 // per
    assert row_threads == cols * g1 == w * g2 and elems >= w * n2 and h >= 1
    clusters = -(-pairs // per)
    tid = np.arange(threads)
    g, i = tid // row_threads, tid % row_threads
    c, t = i % cols, i // cols
    k = np.arange(16)[:, None]                                      # (16, 1)
    q = np.arange(clusters)[:, None, None, None]                    # (Q, 1, 1, 1)
    r = np.arange(ctas)[None, :, None, None]                        # (1, C, 1, 1)
    j2 = r * cols + c                                               # (1, C, 1, T)
    k1 = t + k * g1                                                 # (16, T)
    p = q * per + g                                                 # (Q, 1, 1, T)
    full = (clusters, ctas, 16, threads)
    has_a = np.broadcast_to(2 * p < rows, full)
    has_b = np.broadcast_to(2 * p + 1 < rows, full)
    load_a = np.broadcast_to(2 * p * n + k1 * n2 + j2, full)
    reads = np.bincount(np.concatenate([load_a[has_a], (load_a + n)[has_b]]),
                        minlength=rows * n)
    warps = load_a.reshape(-1, 32)
    loads_128 = bool((np.diff(warps, axis=1) == 1).all() and (warps[:, 0] % 32 == 0).all())
    worst = 1
    log2n1 = n1.bit_length() - 1
    for step in range(log2n1 // 4 - (log2n1 % 4 == 0)):
        log2s = 4 * step
        jj, qq = t >> log2s, t & ((1 << log2s) - 1)
        f = (((jj << 4) << log2s) + qq) + (np.arange(16)[:, None] << log2s)   # (16, T)
        worst = max(worst, _half_warp_banks(g * elems + f * cols + c),
                    _half_warp_banks(g * elems + k1 * cols + c))
    # The exchange: mirror slots.
    sigma = np.where(k1 < n1 // 2, k1, np.where(k1 == n1 // 2, 0, n1 - k1))
    owner = sigma // h
    local = sigma % h + (k1 >= n1 // 2) * h
    every = np.arange(n1)
    s_all = np.where(every < n1 // 2, every, np.where(every == n1 // 2, 0, n1 - every))
    o_all = s_all // h
    l_all = s_all % h + (every >= n1 // 2) * h
    partner = np.where((every == 0) | (every == n1 // 2), every, n1 - every)
    owner_ok = bool(np.unique(o_all * w + l_all).size == n1
                    and (_mirror_row(o_all, l_all, n1, h) == every).all()
                    and (o_all[partner] == o_all).all())
    slot = local * n2 + j2                                           # (1, C, 16, T)
    dest = ((q * ctas + owner) * per + g) * (w * n2) + slot          # (Q, C, 16, T)
    slab_writes = np.bincount(dest.ravel(), minlength=clusters * ctas * per * w * n2)
    remote = np.broadcast_to(g * elems + slot, (1, ctas, 16, threads))
    worst = max(worst, _half_warp_banks(remote))
    remote_whole = _warp_sectors_whole(remote)
    # The row phase's loads.
    rho2, t2 = i // g2, i % g2
    k2 = t2 + k * g2                                                 # (16, T)
    own = rho2 * n2 + k2
    src = ((q * ctas + r) * per + g) * (w * n2) + own                # (Q, C, 16, T)
    slab_reads = np.bincount(src.ravel(), minlength=clusters * ctas * per * w * n2)
    worst = max(worst, _half_warp_banks(g * elems + own))
    z = None
    if x is not None:
        xx = np.asarray(x, np.float64)
        if rows % 2:
            xx = np.vstack([xx, np.zeros((1, n))])
        xx = np.vstack([xx, np.zeros((2 * clusters * per - xx.shape[0], n))])
        zin = (xx[0::2] + 1j * xx[1::2]).reshape(-1)                 # pairs * n
        held = zin[np.broadcast_to(p * n + k1 * n2 + j2, full)]      # (Q, C, 16, T)
        colv = np.zeros((clusters, ctas, per, cols, n1), np.complex128)
        gg, cc, kk1 = (np.broadcast_to(a, (16, threads)) for a in (g, c, k1))
        colv[:, :, gg, cc, kk1] = held
        y = np.fft.fft(colv, axis=-1)
        jj = np.arange(ctas)[:, None] * cols + np.arange(cols)        # (C, cols)
        y = y * np.exp(-2j * np.pi * ((jj[:, None, :, None] * np.arange(n1)) % n) / n)
        slab = np.zeros(clusters * ctas * per * w * n2, np.complex128)
        slab[dest] = y[:, :, gg, cc, kk1]
        b = np.zeros((clusters, ctas, per, w, n2), np.complex128)
        rr2, kk22 = np.broadcast_to(rho2, (16, threads)), np.broadcast_to(k2, (16, threads))
        b[:, :, gg, rr2, kk22] = slab[src]
        z = np.fft.fft(b, axis=-1)                                   # Z[q][r][g][rho][k2]
    return {"n": n, "n1": n1, "n2": n2, "ctas": ctas, "per": per, "threads": threads,
            "smem": smem, "rows": rows, "pairs": pairs, "clusters": clusters, "w": w,
            "h": h, "elems": elems, "g": g, "i": i, "rho2": rho2, "k2": k2,
            "reads": reads, "loads_128": loads_128, "slab_writes": slab_writes,
            "slab_reads": slab_reads, "owner_ok": owner_ok, "worst_bank": worst,
            "remote_whole": remote_whole, "z": z}


def k3_cluster_model(x, *, rows: int | None = None, shape=(64, 2, 1)):
    """K3 at n = 16384 split over a cluster (``packed_cluster_kernel`` of
    ``csrc/rfft_rows_cluster.cuh``, the design the library does not build
    for K3) in float64, thread by thread, in the launch shape ``shape = (n1,
    C, R)`` (its best, the default: 2 CTAs of 1 pair, n1 = 64): ``x`` the
    (rows, n) real rows, or None for the pattern alone (then ``rows``).

    The column phase, the exchange and the row phase are
    ``_packed_cluster_phases``'; then, in pair g's part of the buffer:
    - Stage: bin k2 = t2 + k*G2 of local row rho at slot ``k4_slot(k2*W +
      rho)`` (tstore.cuh's swizzle for W rows of n2).
    - Split: item idx = i + b*T, b < 8, is (q, k2) = (idx % W, idx // W);
      its partner local row q ^ H at bin n2 - 1 - k2, or, in slot 0 (rank 0,
      q % H = 0), row q itself at (n2 - k2) % n2 (q = 0) or n2 - 1 - k2; A
      to out[2p][k], B to out[2p + 1][k] (where that row exists), k = row(q)
      + n1*k2; thread i = 0 of rank 0 also stores bin n/2 from row 0's bin
      n2/2.

    Returns ``_packed_cluster_phases``' dict (its ``worst_bank`` also over
    the staging's writes and the split's reads) and: ``out`` the (rows, n/2
    + 1) result (None without ``x``); ``partner_ok`` whether every item read
    bin (n - k) mod n of its pair; ``writes`` how often each output element
    was stored; ``runs``, ``nbytes`` and ``sectors``: per output store
    instruction (A and B apart), the bytes of each run of consecutive
    elements, its bytes and the 32-byte sectors it touches."""
    m = _packed_cluster_phases(x, rows, shape)
    n, n1, n2, ctas, per = m["n"], m["n1"], m["n2"], m["ctas"], m["per"]
    rows, clusters, w, h, elems = m["rows"], m["clusters"], m["w"], m["h"], m["elems"]
    g, i, rho2, k2 = m["g"], m["i"], m["rho2"], m["k2"]
    threads, row_threads = m["threads"], m["threads"] // per
    nh = n // 2 + 1
    log2w = w.bit_length() - 1
    worst = m["worst_bank"]
    # The staging and the split's reads.
    swz = k4_swizzle(n2, w)
    put = k4_slot((k2 << log2w) + rho2, swz)                         # (16, T)
    assert np.unique(g * elems + put).size == put.size
    worst = max(worst, _half_warp_banks(g * elems + put))
    idx = i + np.arange(8)[:, None] * row_threads                    # (8, T)
    qq, kk2 = idx % w, idx // w
    rr = np.arange(ctas)[:, None, None]                              # (C, 1, 1)
    self_ = (rr == 0) & (qq % h == 0)                                # (C, 8, T)
    pq = np.where(self_, qq, qq ^ h)
    pk = np.where(self_ & (qq == 0), (n2 - kk2) % n2, n2 - 1 - kk2)
    get_k = np.broadcast_to(k4_slot((kk2 << log2w) + qq, swz), pq.shape)
    get_r = k4_slot((pk << log2w) + pq, swz)
    worst = max(worst, _half_warp_banks(g * elems + get_k),
                _half_warp_banks(g * elems + get_r))
    kk = _mirror_row(rr, qq, n1, h) + n1 * kk2                       # (C, 8, T)
    pkk = _mirror_row(rr, pq, n1, h) + n1 * pk
    partner_ok = bool(((pkk % n) == ((n - kk) % n)).all())
    pp = np.arange(clusters)[:, None, None, None] * per + g          # (Q, 1, 1, T)
    bshape = (clusters, ctas, 8, threads)
    kb = np.broadcast_to(kk, bshape)
    a_addr = 2 * pp * nh + kb
    a_live = np.broadcast_to(2 * pp < rows, bshape)
    b_live = np.broadcast_to(2 * pp + 1 < rows, bshape)
    # Bin n/2: thread i = 0 of rank 0 of each pair.
    pe = np.arange(clusters)[:, None] * per + np.arange(per)          # (Q, R)
    e_a = 2 * pe * nh + nh - 1
    e_live_a, e_live_b = 2 * pe < rows, 2 * pe + 1 < rows
    stored = np.concatenate([a_addr[a_live], (a_addr + nh)[b_live], e_a[e_live_a],
                             (e_a + nh)[e_live_b]])
    writes = np.bincount(stored, minlength=rows * nh)
    runs, nbytes, sectors = [], [], []
    for addr_, live in ((a_addr, a_live), (a_addr + nh, b_live)):
        got = _warp_runs(addr_, live)
        runs.append(got[0])
        nbytes.append(got[1])
        sectors.append(got[2])
    out = None
    if x is not None:
        rr2, kk22 = np.broadcast_to(rho2, (16, threads)), np.broadcast_to(k2, (16, threads))
        gg = np.broadcast_to(g, (16, threads))
        staged = np.zeros((clusters, ctas, per, elems), np.complex128)
        staged[:, :, gg, put] = m["z"][:, :, gg, rr2, kk22]
        g8 = np.broadcast_to(g, (8, threads))
        ci = np.arange(ctas)[:, None, None]
        zk = staged[:, ci, g8, get_k]                                # (Q, C, 8, T)
        zr = staged[:, ci, g8, get_r]
        av, bv = (zk + np.conj(zr)) / 2, (zk - np.conj(zr)) / 2j
        out = np.zeros(rows * nh, np.complex128)
        out[a_addr[a_live]] = av[a_live]
        out[(a_addr + nh)[b_live]] = bv[b_live]
        z0 = staged[:, 0, :, k4_slot((n2 // 2) << log2w, swz)]       # (Q, R)
        out[e_a[e_live_a]] = z0[e_live_a].real
        out[(e_a + nh)[e_live_b]] = z0[e_live_b].imag
        out = out.reshape(rows, nh)
    keep = ("reads", "loads_128", "slab_writes", "slab_reads", "owner_ok", "remote_whole")
    return {**{key: m[key] for key in keep}, "out": out, "partner_ok": partner_ok,
            "writes": writes, "worst_bank": worst, "runs": np.concatenate(runs),
            "nbytes": np.concatenate(nbytes), "sectors": np.concatenate(sectors)}


def k4_16k_model(x, *, rows: int | None = None, shape=None):
    """K4 at n = 16384 (``packed_transpose_kernel`` of
    ``csrc/rfft_rows_cluster.cuh``, launched by
    ``csrc/rfft_rows_transpose_16k.cu``) in float64, thread by thread, in
    its launch shape ``rfft_transpose_16k_plan(rows)`` or ``shape = (n1, C,
    R)``: ``x`` the (rows, n) real rows, or None for the pattern alone (then
    ``rows``).

    The column phase, the exchange and the row phase are
    ``_packed_cluster_phases``'; then, over the CTA's whole buffer:
    - Stage: bin k2 = t2 + k*G2 of local row rho of pair g at slot
      ``k4_slot(((k2*W + rho) << log2 R) + g)`` (tstore.cuh's swizzle for P =
      W*R rows of n2).
    - Split at an even row count: item f = tid + b*(R*T), b < 8, is (g, q,
      k2) = (f % R, (f // R) % W, f // (R*W)), k2 < n2/2, reading slot(f)
      and its partner (local row q ^ H at bin n2 - 1 - k2, or in slot 0 its
      own row as in ``k3_cluster_model``) of pair g; A and B of bin k =
      row(q) + n1*k2 of pair p = cluster*R + g as one 16-byte store to
      out[k][2p], out[k][2p + 1].  At an odd row count item f = tid // 2 +
      b*(R*T/2), b < 16, the lane's half tid % 2 choosing A (column 2p) or B
      (2p + 1), 8 bytes a lane, where the column exists.  Lanes tid < R of
      rank 0 store bin n/2 of pair g = tid from row 0's bin n2/2.

    Returns ``_packed_cluster_phases``' dict (its ``worst_bank`` also over
    the staging's writes and the split's reads but rank 0's partner reads,
    each distinct slot of a half-warp counted once; ``self_bank`` rank 0's
    partner reads, where slot 0's two rows are their own partners) and:
    ``shape``; ``out`` the
    (n/2 + 1, rows) result (None without ``x``); ``items_once`` whether the
    split's items cover every (g, q, k2 < n2/2) once on every rank;
    ``partner_ok`` whether every item read bin (n - k) mod n of its pair;
    ``writes`` how often each output element was stored (the stores'
    guards: a column past the last pair's, or an unpaired row's b, is never
    addressed); ``runs`` the bytes of each run of consecutive elements a
    warp store writes to one output row; ``stores_whole`` whether every
    warp store of a cluster whose R pairs all exist with both rows touches
    whole 32-byte sectors only."""
    from repro_torch.kernels.fused.real import rfft_transpose_16k_plan

    rows = x.shape[0] if x is not None else rows
    if shape is None:
        n1, _, ctas, per, *_ = rfft_transpose_16k_plan(rows)
        shape = (n1, ctas, per)
    m = _packed_cluster_phases(x, rows, shape)
    n, n1, n2, ctas, per = m["n"], m["n1"], m["n2"], m["ctas"], m["per"]
    clusters, w, h, threads = m["clusters"], m["w"], m["h"], m["threads"]
    g, rho2, k2 = m["g"], m["rho2"], m["k2"]
    nh = n // 2 + 1
    log2w, log2r = w.bit_length() - 1, per.bit_length() - 1
    log2p = log2w + log2r
    worst = m["worst_bank"]
    swz = k4_swizzle(n2, w * per)
    put = k4_slot((((k2 << log2w) + rho2) << log2r) + g, swz)        # (16, T)
    assert np.unique(put).size == put.size and put.max() < m["smem"] // 8
    worst = max(worst, _half_warp_banks(put))
    odd = rows % 2 == 1
    tid = np.arange(threads)
    steps = 16 if odd else 8
    f = ((tid >> 1) if odd else tid) + np.arange(steps)[:, None] * (threads // (2 if odd else 1))
    half = np.broadcast_to(tid & 1 if odd else 0, f.shape)          # (S, T)
    gq, qq, kk2 = f & (per - 1), (f >> log2r) & (w - 1), f >> log2p
    items = np.bincount(f[half == 0].ravel(), minlength=per * w * n2 // 2)
    items_once = bool((items == 1).all() and items.size == per * w * n2 // 2)
    rr = np.arange(ctas)[:, None, None]                              # (C, 1, 1)
    self_ = (rr == 0) & (qq % h == 0)                                # (C, S, T)
    pq = np.where(self_, qq, qq ^ h)
    pk = np.where(self_ & (qq == 0), (n2 - kk2) % n2, n2 - 1 - kk2)
    get_k = np.broadcast_to(k4_slot(f, swz), pq.shape)
    get_r = k4_slot((((pk << log2w) + pq) << log2r) + gq, swz)
    worst = max(worst, _half_warp_distinct_banks(get_k), _half_warp_distinct_banks(get_r[1:]))
    self_bank = _half_warp_distinct_banks(get_r[0])
    kk = _mirror_row(rr, qq, n1, h) + n1 * kk2                       # (C, S, T)
    pkk = _mirror_row(rr, pq, n1, h) + n1 * pk
    partner_ok = bool(((pkk % n) == ((n - kk) % n)).all())
    # The stores: per (cluster, rank, step, lane) the output elements
    # written, column 2p + half (odd) or 2p and 2p + 1 (even).
    cq = np.arange(clusters)[:, None, None, None]                    # (Q, 1, 1, 1)
    p = cq * per + gq                                                # (Q, 1, S, T)
    shp = (clusters, ctas, steps, threads)
    kb = np.broadcast_to(kk, shp)
    col0 = np.broadcast_to(2 * p + half, shp)
    halves = (col0,) if odd else (col0, col0 + 1)
    addrs = [kb * rows + col for col in halves]
    lives = [col < rows for col in halves]
    # Bin n/2: lanes tid < R of rank 0.
    pe = np.arange(clusters)[:, None] * per + np.arange(per)          # (Q, R)
    e_cols = [2 * pe, 2 * pe + 1]
    e_addr = [(nh - 1) * rows + col for col in e_cols]
    e_live = [col < rows for col in e_cols]
    writes = np.bincount(np.concatenate([a[l] for a, l in zip(addrs + e_addr,
                                                             lives + e_live)]),
                         minlength=nh * rows)
    # Runs and sectors of each warp store instruction (the even path's
    # 16-byte stores: both elements of a lane in one instruction).
    lane_addr = np.stack(addrs, -1).reshape(clusters, ctas, steps, -1)
    lane_live = np.stack(lives, -1).reshape(lane_addr.shape)
    width = 32 * len(halves)
    runs = _warp_runs(lane_addr.reshape(-1, width), lane_live.reshape(-1, width), width)[0]
    whole_clusters = clusters if rows % (2 * per) == 0 else clusters - 1
    _, nb, sec = _warp_runs(lane_addr[:whole_clusters].reshape(-1, width),
                            lane_live[:whole_clusters].reshape(-1, width), width)
    stores_whole = bool((nb == 32 * sec).all())
    out = None
    if x is not None:
        rr2, kk22 = np.broadcast_to(rho2, (16, threads)), np.broadcast_to(k2, (16, threads))
        gg = np.broadcast_to(g, (16, threads))
        staged = np.zeros((clusters, ctas, m["smem"] // 8), np.complex128)
        staged[:, :, put] = m["z"][:, :, gg, rr2, kk22]
        ci = np.arange(ctas)[:, None, None]
        zk = staged[:, ci, get_k]                                    # (Q, C, S, T)
        zr = staged[:, ci, get_r]
        spec = ((zk + np.conj(zr)) / 2, (zk - np.conj(zr)) / 2j)
        out = np.zeros(nh * rows, np.complex128)
        if odd:
            value = np.where(half == 1, spec[1], spec[0])
            out[addrs[0][lives[0]]] = value[lives[0]]
        else:
            for a, l, v in zip(addrs, lives, spec):
                out[a[l]] = v[l]
        z0 = staged[:, 0, k4_slot(((n2 // 2) << log2p) + np.arange(per), swz)]   # (Q, R)
        for a, l, v in zip(e_addr, e_live, (z0.real, z0.imag)):
            out[a[l]] = v[l]
        out = out.reshape(nh, rows)
    keep = ("reads", "loads_128", "slab_writes", "slab_reads", "owner_ok", "remote_whole")
    return {**{key: m[key] for key in keep}, "shape": tuple(shape), "out": out,
            "items_once": items_once, "partner_ok": partner_ok,
            "writes": writes.reshape(nh, rows), "worst_bank": worst, "self_bank": self_bank,
            "runs": runs, "stores_whole": stores_whole}


def k3_16k_model(x, *, rows: int | None = None, sms: int = 132):
    """K3 at n = 16384 (``csrc/rfft_rows_16k.cu``'s
    ``rfft_persistent_kernel<2, kStaged>``) in float64, thread by thread, in
    its launch ``rfft_16k_plan(rows, sms)`` on a card of ``sms`` SMs: ``x``
    the (rows, n) real rows, or None for the pattern alone (then ``rows``).

    CTA c of C = min(pairs, sms) takes pairs c, c + C, ...; pair p's staging
    (issued before the loop, or after the previous pair's reads) copies the
    floats [2p*n, 2p*n + S) to the staging area, S = n + kStaged*1024 where
    row b exists (n where it does not), in 16 KiB bulk copies, and has the
    rest of b, [2p*n + S, (2p + 2)*n), prefetched into L2.  Thread t of its
    1024 loads re[k] = staged float t + k*1024 and im[k] = staged float n +
    t + k*1024 for k < kStaged, x[2p + 1][t + k*1024] above (zeros without
    b); the passes are regfft's Plan<14> (``kernel_pass_model``); the split
    is ``rfft_rows_kernel``'s: item k = t + c*1024 < n/2 + 1 reads Z[k] and
    Z[(n - k) mod n] and writes A to out[2p][k], B to out[2p + 1][k].

    Returns a dict: ``out`` the (rows, n/2 + 1) result (None without
    ``x``); ``pairs_of`` the CTA of every pair, ``order_ok`` whether each
    CTA runs its pairs in rising order, one per iteration; ``copied`` how
    often each input float was staged or prefetched (and ``overrun``
    whether a staging or prefetch reached past the input); ``staged_reads``
    / ``global_reads`` how often each input float was read from the staging
    area / from memory, ``in_range`` whether every staged read lies in its
    pair's staged range and every read from memory in its prefetched one;
    ``reads`` how often each input float was loaded in all; ``writes`` how
    often each output element was stored; ``worst_bank`` the worst count of
    a half-warp's lanes on one bank of the staging reads and of the passes'
    exchanges (``kernel_pass_model``); ``layout`` the exchange buffer's,
    staging area's and mbarrier's byte offsets and the total; ``chunks``
    the sizes of the bulk copies of a pair with b; ``runs`` the bytes of
    each run of consecutive elements a warp's store writes and
    ``sectors_whole`` whether each warp store (A and B apart) touches
    whole 32-byte sectors only."""
    from repro_torch.kernels.fft.kernel import complex_rows_plan
    from repro_torch.kernels.fft.real import RFFT_16K_STAGED, rfft_16k_plan

    n, g = 1 << 14, 1024
    nh = n // 2 + 1
    rows = x.shape[0] if x is not None else rows
    pairs = (rows + 1) // 2
    ctas, threads, staged_bytes, smem = rfft_16k_plan(rows, sms)
    assert threads == g
    exchange = 8 * (n + n // 16)
    layout = (0, exchange, exchange + staged_bytes, smem)
    p = np.arange(pairs)
    pairs_of = p % ctas
    order_ok = bool((p // ctas == np.arange(pairs) // ctas).all())
    has_b = 2 * p + 1 < rows
    size = np.where(has_b, staged_bytes // 4, n)                  # staged floats
    lo = 2 * p * n
    copied = np.zeros(rows * n + 1, np.int64)
    np.add.at(copied, np.minimum(np.concatenate(
        [np.arange(a, a + m) for a, m in zip(lo, size)]), rows * n), 1)
    pre_lo, pre_hi = lo + size, np.where(has_b, lo + 2 * n, lo + size)
    np.add.at(copied, np.minimum(np.concatenate(
        [np.arange(a, b) for a, b in zip(pre_lo, pre_hi)]), rows * n), 1)
    overrun = bool(copied[rows * n] > 0)
    copied = copied[:rows * n]
    chunks = [min(16384, staged_bytes - off) for off in range(0, staged_bytes, 16384)]
    t = np.arange(g)
    k = np.arange(16)[:, None]
    slot = t + k * g                                               # (16, T)
    staged_slots = np.concatenate([slot, n + slot[:RFFT_16K_STAGED]])   # re, then im
    staged_el = lo[:, None, None] + staged_slots[None]             # (P, 16 + S, T)
    keep = np.ones(staged_el.shape, bool)
    keep[:, 16:] = has_b[:, None, None]
    global_el = (lo + n)[:, None, None] + slot[None, RFFT_16K_STAGED:]
    gkeep = np.broadcast_to(has_b[:, None, None], global_el.shape)
    staged_reads = np.bincount(staged_el[keep], minlength=rows * n)
    global_reads = np.bincount(global_el[gkeep], minlength=rows * n)
    in_range = bool(((staged_el >= lo[:, None, None])
                     & (staged_el < (lo + size)[:, None, None]))[keep].all()
                    and ((global_el >= pre_lo[:, None, None])
                         & (global_el < pre_hi[:, None, None]))[gkeep].all())
    # A warp's staging reads: 32 floats, one a 4-byte bank each.
    worst = max(int(np.bincount(w % 32, minlength=32).max())
                for w in staged_slots.reshape(-1, 32))
    # The split's stores.
    c = np.arange(-(-nh // g))[:, None]
    item = t + c * g                                               # (9, T)
    live = item < nh
    a_addr = 2 * p[:, None, None] * nh + item[None]
    a_live = np.broadcast_to(live, a_addr.shape)
    b_live = a_live & has_b[:, None, None]
    writes = np.bincount(np.concatenate([a_addr[a_live], (a_addr + nh)[b_live]]),
                         minlength=rows * nh)
    runs, whole = [], True
    for addr_, m in ((a_addr, a_live), (a_addr + nh, b_live)):
        got, nbytes, sectors = _warp_runs(addr_, m)
        runs.append(got)
        whole = whole and bool((nbytes == 32 * sectors).all())
    out = None
    if x is not None:
        xx = np.asarray(x, np.float64)
        if rows % 2:
            xx = np.vstack([xx, np.zeros((1, n))])
        z = torch.from_numpy(xx[0::2] + 1j * xx[1::2])
        zz, pass_worst = kernel_pass_model(z, complex_rows_plan(n, 1))
        worst = max(worst, pass_worst)
        zz = zz.numpy()
        kk = np.arange(nh)
        zk, zr = zz[:, kk], zz[:, (n - kk) % n]
        av, bv = (zk + np.conj(zr)) / 2, (zk - np.conj(zr)) / 2j
        out = np.zeros((rows, nh), np.complex128)
        out[0::2] = av[:(rows + 1) // 2]
        out[1::2] = bv[:rows // 2]
    return {"out": out, "pairs_of": pairs_of, "order_ok": order_ok, "copied": copied,
            "overrun": overrun, "staged_reads": staged_reads, "global_reads": global_reads,
            "in_range": in_range, "reads": staged_reads + global_reads, "writes": writes,
            "worst_bank": worst, "layout": layout, "chunks": chunks,
            "runs": np.concatenate(runs), "sectors_whole": whole}


def cluster_twiddle_model(n: int, g: int, t: np.ndarray, j2: np.ndarray, *,
                          inverse: bool = False) -> np.ndarray:
    """The one-pass kernel's twiddles (``column_twiddles`` of
    ``csrc/fourstep_cluster.cuh``) in float32 arithmetic: w_n^(k1*j2) for
    k1 = t + k*g, k < 16, as h_kh * b^kl (k = 4*kh + kl) with h_kh =
    w^((t + 4*kh*g)*j2) and b = w^(g*j2) each a correctly rounded float32
    cosine and sine (as sincospif gives them, to about an ulp), b^kl by
    running complex64 products.  Returns complex64 of shape (16,) +
    broadcast(t, j2).shape."""
    sign = 1.0 if inverse else -1.0

    def unit(m):
        angle = 2.0 * np.pi * np.asarray(m, np.float64) / n
        return (np.cos(angle).astype(np.float32)
                + 1j * (sign * np.sin(angle)).astype(np.float32)).astype(np.complex64)

    t, j2 = np.broadcast_arrays(np.asarray(t), np.asarray(j2))
    b = unit(g * j2)
    out = np.empty((16,) + t.shape, np.complex64)
    for kh in range(4):
        w = unit((t + 4 * kh * g) * j2)
        for kl in range(4):
            out[4 * kh + kl] = w
            w = (w * b).astype(np.complex64)
    return out


def column_slot(x: np.ndarray, cols: int) -> np.ndarray:
    """``column_slot<COLS>`` of ``csrc/fourstep.cuh``: element x = f*cols + c
    of the column exchange at x itself (cols >= 16), else padded by cols
    slots a block of 16*cols."""
    return x if cols >= 16 else x + x // (16 * cols) * cols


def pass_a_twiddle_model(n: int, g: int, t: np.ndarray, j2: np.ndarray, *,
                         inverse: bool = False) -> np.ndarray:
    """Pass A's twiddles in the complex modes (``column_twiddles<INV, true>``
    of ``csrc/fourstep.cuh``) in float32 arithmetic: w_n^(k1*j2) for k1 = t
    + k*g, k < 16, as h_kh * b^kl (k = 4*kh + kl) with the five base values
    h_kh = w^((t + 4*kh*g)*j2) and b = w^(g*j2) each ``large_twiddle``'s
    split (``twiddle<INV>``), b^kl by running complex64 products.  Returns
    complex64 of shape (16,) + broadcast(t, j2).shape."""
    from repro_torch.kernels.fft.large import large_twiddle

    t, j2 = np.broadcast_arrays(np.asarray(t, np.int64), np.asarray(j2, np.int64))

    def base(m):
        return large_twiddle(torch.from_numpy(np.ascontiguousarray(m)), n,
                             inverse=inverse).numpy()

    b = base(g * j2)
    out = np.empty((16,) + t.shape, np.complex64)
    for kh in range(4):
        w = base((t + 4 * kh * g) * j2)
        for kl in range(4):
            out[4 * kh + kl] = w
            w = (w * b).astype(np.complex64)
    return out


def pass_a_model(x, n1: int, n2: int, *, rows: int | None = None,
                 transposed: bool = False, inverse: bool = False, tiles=None):
    """Pass A of K1b and K2b (``complex_columns_kernel`` of
    ``csrc/fourstep.cuh``) in float64, thread by thread, in its launch shape
    ``columns_plan(n1) = (cols, threads, smem)``: ``x`` the (rows, n1*n2)
    complex rows, or None for the pattern alone (then ``rows``); ``tiles``
    (default: all) the tiles simulated.

    Tile b = s*(n2/cols) + g holds columns j2 = g*cols + c of row s; thread
    t*cols + c (G = n1/16 threads a column) loads A[t + k*G][j2] =
    x[s*n + (t + k*G)*n2 + j2], k < 16; the column DFT's exchanges put
    element f of column c at ``column_slot(f*cols + c)``; the result Y[k1][j2]
    times the exact twiddle w_n^(k1*j2), k1 = t + k*G, goes to the scratch
    at the load's own address ([s][k1][j2]) or, ``transposed``, at (k1*cap +
    s)*n2 + j2, cap = the least power of two >= rows.

    Returns a dict: ``load`` and ``store`` (tiles, 16, T) element addresses;
    ``reads``, ``writes`` how often each input and scratch element was
    loaded and stored (over the simulated tiles); ``loads_whole``,
    ``stores_whole`` whether every warp instruction touches whole 32-byte
    sectors only; ``loads_256``, ``stores_256`` whether every warp
    instruction is 32 consecutive elements from a 256-byte boundary;
    ``worst_bank`` the worst count of a half-warp's lanes on one bank over
    the column exchanges' writes and reads; ``scratch`` the (cap or rows)*n
    scratch (None without ``x``); ``cap`` and ``plan``."""
    from repro_torch.kernels.fft.large import columns_plan

    n = n1 * n2
    rows = x.shape[0] if x is not None else rows
    cap = 1 << max(0, rows - 1).bit_length() if transposed else rows
    cols, threads, smem = columns_plan(n1)
    group = n1 // 16
    tid = np.arange(threads)
    c, t = tid % cols, tid // cols
    groups = n2 // cols
    tile = np.arange(rows * groups) if tiles is None else np.asarray(tiles)
    s, g = tile // groups, tile % groups
    j2 = g[:, None, None] * cols + c                                   # (B, 1, T)
    k1 = t + np.arange(16)[:, None] * group                            # (16, T)
    load = s[:, None, None] * n + k1[None] * n2 + j2                   # (B, 16, T)
    store = (k1[None] * cap + s[:, None, None]) * n2 + j2 if transposed else load
    reads = np.bincount(load.ravel(), minlength=rows * n)
    writes = np.bincount(store.ravel(), minlength=cap * n)

    def runs_256(addr):
        warps = addr.reshape(-1, 32)
        return bool((np.diff(warps, axis=1) == 1).all() and (warps[:, 0] % 32 == 0).all())

    worst = 1
    log2n1 = n1.bit_length() - 1
    elems = smem // 8
    for p in range(log2n1 // 4 - (log2n1 % 4 == 0)):
        log2s = 4 * p
        jj, qq = t >> log2s, t & ((1 << log2s) - 1)
        f = (((jj << 4) << log2s) + qq) + (np.arange(16)[:, None] << log2s)   # (16, T)
        put = column_slot(f * cols + c, cols)
        get = column_slot(k1 * cols + c, cols)
        # As the kernel adds them: one slot a thread plus constants.
        base = column_slot((((jj << 4) << log2s) + qq) * cols + c, cols)
        assert np.array_equal(put, base + column_slot((np.arange(16)[:, None] << log2s) * cols,
                                                      cols))
        assert np.array_equal(get, column_slot(t * cols + c, cols)
                              + column_slot(np.arange(16)[:, None] * group * cols, cols))
        assert np.unique(put).size == 16 * threads and put.max() < elems
        assert np.array_equal(np.sort(put.ravel()), np.sort(get.ravel()))
        worst = max(worst, _half_warp_banks(put), _half_warp_banks(get))
    scratch = None
    if x is not None:
        xx = np.asarray(x, np.complex128).reshape(-1)
        colv = np.zeros((tile.size, cols, n1), np.complex128)
        cc, kk1 = np.broadcast_to(c, (16, threads)), np.broadcast_to(k1, (16, threads))
        colv[:, cc, kk1] = xx[load]
        y = (np.fft.ifft if inverse else np.fft.fft)(colv, axis=-1)
        sign = 1.0 if inverse else -1.0
        jj = g[:, None] * cols + np.arange(cols)                        # (B, cols)
        y = y * np.exp(sign * 2j * np.pi * ((jj[:, :, None] * np.arange(n1)) % n) / n)
        scratch = np.zeros(cap * n, np.complex128)
        scratch[store] = y[:, cc, kk1]
    return {"load": load, "store": store, "reads": reads, "writes": writes,
            "loads_whole": _warp_sectors_whole(load), "stores_whole": _warp_sectors_whole(store),
            "loads_256": runs_256(load), "stores_256": runs_256(store), "worst_bank": worst,
            "scratch": scratch, "cap": cap, "plan": (cols, threads, smem)}


def pass_b_plan(n2: int, brows: int):
    """Pass B's launch shape for ``brows`` rows of B (``rows_plan``) as
    ``k2_store_model`` takes it: ``((rows_per_cta, threads, 16), ctas)``."""
    from repro_torch.kernels.fft.large import rows_plan

    rows_per_cta, threads, ctas = rows_plan(n2, brows)
    return (rows_per_cta, threads, 16), ctas


def k1b_model(x, n1: int, n2: int, *, rows: int | None = None, inverse: bool = False):
    """K1b's two passes (``csrc/fft_rows_large.cu`` on ``csrc/fourstep.cuh``)
    in float64, thread by thread, in their launch shapes: ``x`` the (rows,
    n1*n2) complex rows, or None for the pattern alone (then ``rows``).

    Pass A: ``pass_a_model``, B stored as [s][k1][j2].  Pass B: K2's store
    (``k2_store_model``) in pass B's shape (``pass_b_plan(n2, rows*n1)``:
    P rows a CTA, clusters of C) over the rows*n1 rows of the scratch, each
    (k2, row R = s*n1 + k1) sent to out[s*n + k2*n1 + k1].

    Returns ``(out, pass_a, writes_b, runs_b, plan_b, cluster)``: the (rows,
    n) result (None without ``x``); ``pass_a_model``'s dict; how often pass
    B wrote each output element; ``k2_store_model``'s runs (bytes,
    contiguous, full) of pass B's warps; its plan and cluster."""
    n = n1 * n2
    rows = x.shape[0] if x is not None else rows
    pass_a = pass_a_model(x, n1, n2, rows=rows, inverse=inverse)
    plan_b, cluster = pass_b_plan(n2, rows * n1)
    z = None
    if x is not None:
        b = pass_a["scratch"].reshape(rows * n1, n2)
        z = torch.from_numpy(np.fft.ifft(b, axis=-1) if inverse else np.fft.fft(b, axis=-1))
    out_t, writes_t, _, runs_b = k2_store_model(z, rows * n1, plan_b, cluster=cluster)
    big_r = np.arange(rows * n1)
    dest = (big_r // n1) * n + np.arange(n2)[:, None] * n1 + big_r % n1   # (n2, R)
    live = writes_t[:, :rows * n1] > 0
    writes_b = np.zeros(rows * n, np.int64)
    np.add.at(writes_b, dest[live], writes_t[:, :rows * n1][live])
    out = None
    if out_t is not None:
        out = np.zeros(rows * n, np.complex128)
        out[dest] = out_t
        out = out.reshape(rows, n)
    return out, pass_a, writes_b, runs_b, plan_b, cluster


def k2b_model(x, n1: int, n2: int, *, rows: int | None = None,
              out_stride: int | None = None, r0: int = 0, inverse: bool = False):
    """K2b's two passes (``csrc/fft_rows_transpose_large.cu`` on
    ``csrc/fourstep.cuh``) in float64, thread by thread, for one chunk of
    ``rows`` rows (those of ``x``, or the pattern alone) stored to columns
    ``r0 ...`` of an (n, ``out_stride``) output.

    Pass A: ``pass_a_model`` with B stored as [k1][s][j2], cap rows a k1 (the
    least power of two >= rows): the rows of one k1 side by side.  Pass B:
    K2's store (``k2_store_model``) in pass B's shape (``pass_b_plan(n2,
    cap*n1)``) over the cap*n1 rows of the scratch, row R = k1*cap + s and
    bin k2 sent to out[k1 + n1*k2, r0 + s] where s < rows (the others load
    zeros and store nothing).

    Returns ``(out, pass_a, writes_b, runs_b, plan_b, cluster)``: the (n,
    out_stride) result (None without ``x``); ``pass_a_model``'s dict; how
    often pass B wrote each output element; ``k2_store_model``'s runs
    (bytes, contiguous, full); pass B's plan and cluster."""
    n = n1 * n2
    rows = x.shape[0] if x is not None else rows
    out_stride = rows if out_stride is None else out_stride
    pass_a = pass_a_model(x, n1, n2, rows=rows, transposed=True, inverse=inverse)
    cap = pass_a["cap"]
    plan_b, cluster = pass_b_plan(n2, cap * n1)
    z = None
    if x is not None:
        b = pass_a["scratch"].reshape(cap * n1, n2)
        b[np.arange(cap * n1) % cap >= rows] = 0      # masked rows load zeros
        z = torch.from_numpy(np.fft.ifft(b, axis=-1) if inverse else np.fft.fft(b, axis=-1))
    out_t, writes_t, _, runs_b = k2_store_model(z, cap * n1, plan_b, cluster=cluster)
    big_r = np.arange(cap * n1)
    k1_of, s_of = big_r // cap, big_r % cap
    dest = (k1_of + n1 * np.arange(n2)[:, None]) * out_stride + r0 + s_of   # (n2, R)
    live = (writes_t[:, :cap * n1] > 0) & (s_of < rows)
    writes_b = np.zeros(n * out_stride, np.int64)
    np.add.at(writes_b, dest[live], writes_t[:, :cap * n1][live])
    out = None
    if out_t is not None:
        out = np.zeros(n * out_stride, np.complex128)
        out[dest[live]] = out_t[live]
        out = out.reshape(n, out_stride)
    return out, pass_a, writes_b, runs_b, plan_b, cluster


def real_pass_b_model(x, n1: int, n2: int, plan, cluster: int, *, transposed: bool,
                      rows: int | None = None, out_stride: int | None = None, c0: int = 0,
                      clusters=None):
    """Pass B of K3b and K4b with the slot split (``rows_split_kernel`` of
    ``csrc/fourstep.cuh``) in float64, thread by thread, for one chunk of
    ``rows`` real rows (those of ``x``, or the pattern alone).

    Pass A's packed B (column DFTs and twiddles, as ``k1b_model``) lies in
    scratch as [p][k1][j2] (K3b) or [k1][p][j2] with cap = the least power of
    two >= pairs (K4b).  ``plan`` is ``split_rows_plan(n2, units*2)``'s
    (P rows a CTA, T threads) and ``cluster`` its C: a cluster holds W =
    P*C rows, W/2 units, unit u = p*(n1/2) + sigma (K3b) or sigma*cap + p
    (K4b); cluster row q < W/2 is the left row (k1 = sigma) of unit u0 + q,
    q >= W/2 the right row (n1 - sigma, n1/2 for sigma = 0) of unit u0 + q -
    W/2.  Rank r of the cluster stores items (q, k2) for k2 in [r*HB, (r +
    1)*HB), HB = n2/(2C): thread t, step c < 8 takes idx = t + c*T, q = idx
    % W, k2 = r*HB + idx // W, reads Z(q, k2) and its partner Z(q ^ W/2,
    n2 - 1 - k2) (slot 0: row q itself, bin (n2 - k2) % n2 on the left,
    n2 - 1 - k2 on the right) and writes A to out[2p, k] and B to out[2p +
    1, k], k = k1 + n1*k2 (K3b), or to out[k, c0 + 2p] and out[k, c0 + 2p +
    1] (K4b; one 16-byte store where ``out_stride`` and ``c0`` are even); B
    not where 2p + 1 = rows, nothing where p >= pairs.  Thread t < W/2 of
    rank 0 also writes bin n/2 from row 0's bin n2/2 where its unit is in
    slot 0.  ``clusters`` (default: all) picks the clusters simulated.

    Returns a dict: ``out`` (the result, None without ``x``), ``reads`` (how
    often each scratch row was loaded), ``addr`` (the element address of
    every store, row*out_stride + column, A and B), ``expected`` (the
    addresses the simulated clusters' rows own: bins k2 < n2/2 of both
    output rows, and n/2 in slot 0), ``partner_ok`` (every read partner is
    bin (n - k) mod n of the same pair, in a row of the same cluster),
    ``self_items`` (items read beside themselves: rows 0 and n1/2),
    ``runs`` (per warp store instruction: bytes, 32-byte sectors touched,
    maximal contiguous runs, and the lengths of those runs in bytes), and
    ``shape`` (W, units, cap)."""
    n = n1 * n2
    h = n2 // 2
    rows = x.shape[0] if x is not None else rows
    pairs = (rows + 1) // 2
    cap = 1 << max(0, pairs - 1).bit_length() if transposed else 0
    per_cta, threads = plan[:2]
    group = n2 // 16
    assert threads == per_cta * group
    wide = per_cta * cluster
    half = wide // 2
    units = (n1 // 2) * cap if transposed else pairs * (n1 // 2)
    assert wide >= 2 and units % half == 0
    nh = n // 2 + 1
    if out_stride is None:
        out_stride = rows if transposed else nh
    all_clusters = units // half
    cl = np.arange(all_clusters) if clusters is None else np.asarray(clusters)

    def slot_row(u, right):
        if transposed:
            sigma, p = u // cap, u % cap
        else:
            sigma, p = u % (n1 // 2), u // (n1 // 2)
        k1 = np.where(~right, sigma, np.where(sigma == 0, n1 // 2, n1 - sigma))
        return p, sigma, k1

    def scratch_row(p, k1):
        return k1 * cap + p if transposed else p * n1 + k1

    q = np.arange(wide)[None, :]
    p_q, sig_q, k1_q = slot_row(cl[:, None] * half + (q & (half - 1)), q >= half)
    live = p_q < pairs
    reads = np.bincount(scratch_row(p_q, k1_q)[live],
                        minlength=(cap if transposed else pairs) * n1)
    zrows = None
    out = None
    if x is not None:
        xx = np.asarray(x, np.float64)
        if rows % 2:
            xx = np.vstack([xx, np.zeros((1, n))])
        a = (xx[0::2] + 1j * xx[1::2]).reshape(pairs, n1, n2)
        y = np.fft.fft(a, axis=1) * np.exp(
            -2j * np.pi * ((np.arange(n1)[:, None] * np.arange(n2)) % n) / n)
        scratch = np.zeros(((cap if transposed else pairs) * n1, n2), np.complex128)
        if transposed:
            scratch.reshape(n1, cap, n2)[:, :pairs] = y.transpose(1, 0, 2)
        else:
            scratch[:] = y.reshape(pairs * n1, n2)
        zrows = np.zeros((cl.size, wide, n2), np.complex128)
        zrows[live] = np.fft.fft(scratch[scratch_row(p_q, k1_q)[live]], axis=-1)
        out = np.zeros((nh, out_stride) if transposed else (rows, out_stride), np.complex128)
    # The store: CTA (cluster, rank), step c, thread t.
    log2w = wide.bit_length() - 1
    hb = h // cluster
    rank = np.arange(cluster)[None, :, None, None]
    idx = np.arange(threads)[None, None, None, :] + np.arange(8)[None, None, :, None] * threads
    qq = np.broadcast_to(idx & (wide - 1), (cl.size, cluster, 8, threads))
    k2 = np.broadcast_to(rank * hb + (idx >> log2w), qq.shape)
    ci = np.broadcast_to(np.arange(cl.size)[:, None, None, None], qq.shape)
    right = qq >= half
    p, sigma, k1 = slot_row(cl[ci] * half + (qq & (half - 1)), right)
    pq = np.where(sigma == 0, qq, qq ^ half)
    pk = np.where((sigma == 0) & ~right, (n2 - k2) % n2, n2 - 1 - k2)
    pp, _, pk1 = slot_row(cl[ci] * half + (pq & (half - 1)), pq >= half)
    k = k1 + n1 * k2
    partner_ok = bool(((pp == p) & ((pk1 + n1 * pk) % n == (n - k) % n)
                       & (pq >= 0) & (pq < wide)).all())
    stored = p < pairs
    self_items = int((stored & (pq == qq)).sum())
    # Bin n/2 from row 0's bin n2/2: thread t < W/2 of rank 0, slot 0.
    t0 = np.arange(half)[None, :]
    p0, s0, _ = slot_row(cl[:, None] * half + t0, np.zeros(t0.shape, bool))
    extra = (s0 == 0) & (p0 < pairs)
    self_items += int(extra.sum())
    vec = transposed and out_stride % 2 == 0 and c0 % 2 == 0
    has_b = 2 * p + 1 < rows

    def where_to(pr, kk, second):
        return (kk * out_stride + c0 + 2 * pr + second if transposed
                else (2 * pr + second) * out_stride + kk)

    a_addr, b_addr = where_to(p, k, 0), where_to(p, k, 1)
    ea, eb = where_to(p0, n // 2, 0), where_to(p0, n // 2, 1)
    e_has_b = 2 * p0 + 1 < rows
    addr = np.concatenate([a_addr[stored], b_addr[stored & has_b], ea[extra],
                           eb[extra & e_has_b]])
    # The addresses the clusters' rows own: the first half of both rows of
    # every live unit, and bin n/2 of slot 0's left row.
    ob = np.arange(h)
    own = (p_q < pairs)[..., None]
    ok = np.broadcast_to(k1_q[..., None] + n1 * ob, own.shape[:2] + (h,))
    opr = np.broadcast_to(p_q[..., None], ok.shape)
    own = np.broadcast_to(own, ok.shape)
    expected = np.concatenate([where_to(opr[own], ok[own], 0),
                               where_to(opr[own & (2 * opr + 1 < rows)],
                                        ok[own & (2 * opr + 1 < rows)], 1),
                               ea[extra], eb[extra & e_has_b]])
    if zrows is not None:
        zk = zrows[ci, qq, k2]
        zr = zrows[ci, pq, pk]
        av, bv = (zk + np.conj(zr)) / 2, (zk - np.conj(zr)) / 2j
        out.reshape(-1)[a_addr[stored]] = av[stored]
        out.reshape(-1)[b_addr[stored & has_b]] = bv[stored & has_b]
        z0 = zrows[np.arange(cl.size)[:, None].repeat(half, 1), t0.repeat(cl.size, 0), h]
        out.reshape(-1)[ea[extra]] = z0[extra].real
        out.reshape(-1)[eb[extra & e_has_b]] = z0[extra & e_has_b].imag
    # Warp instructions: (cluster, rank, c, warp) x {A, B}, or one 16-byte
    # store of both where vec; each lane writes 8 (or 16) bytes at 8*addr.
    lanes = (cl.size, cluster, 8, threads // 32, 32)

    def instr(addr_, mask, nbytes):
        return addr_.reshape(lanes), mask.reshape(lanes), nbytes

    if vec:
        groups = [instr(a_addr, stored & has_b, 16), instr(a_addr, stored & ~has_b, 8)]
    else:
        groups = [instr(a_addr, stored, 8), instr(b_addr, stored & has_b, 8)]
    run_bytes, run_sectors, run_count, run_lengths = [], [], [], []
    for ad, m, nbytes in groups:
        ad = ad.reshape(-1, 32)
        m = m.reshape(-1, 32)
        hit = m.any(1)
        ad, m = ad[hit], m[hit]
        lo = np.where(m, ad * 8, np.iinfo(np.int64).max)
        order = np.sort(lo, axis=1)
        valid = order < np.iinfo(np.int64).max
        count = valid.sum(1)
        run_bytes.append(count * nbytes)
        first = order // 32
        last = (order + nbytes - 1) // 32
        sectors = np.zeros(order.shape[0], np.int64)
        prev = np.full(order.shape[0], -1)
        breaks = np.zeros(order.shape, bool)
        for j in range(32):
            v = valid[:, j]
            sectors += np.where(v, last[:, j] - np.maximum(first[:, j], prev + 1) + 1, 0)
            prev = np.where(v, np.maximum(prev, last[:, j]), prev)
            if j:
                breaks[:, j] = v & (order[:, j] != order[:, j - 1] + nbytes)
            else:
                breaks[:, j] = v
        run_sectors.append(sectors)
        run_count.append(breaks.sum(1))
        starts = np.flatnonzero(breaks.reshape(-1))
        flat_valid = valid.reshape(-1)
        run_lengths.append(np.add.reduceat(flat_valid.astype(np.int64), starts) * nbytes
                           if starts.size else np.zeros(0, np.int64))
    runs = tuple(np.concatenate(part) for part in (run_bytes, run_sectors, run_count,
                                                   run_lengths))
    return {"out": out, "reads": reads, "addr": addr, "expected": expected,
            "partner_ok": partner_ok, "self_items": self_items, "runs": runs,
            "shape": (wide, units, cap)}
