"""What the redesigned row log-sum-exp and log-mel kernels rest on, as far as
a machine without a GPU can check it:

* the 3xTF32 split of ``csrc/lse.cu`` (hi = the float32 value with its low
  13 bits cleared, which is what the tensor cores read; lo = x - hi rounded
  to the nearest TF32 value; three float32 products), emulated in torch and
  held to the kernel's tolerance against a float64 log-sum-exp, and its
  accumulation (each group of six products in a fresh accumulator whose
  adds truncate, as the tensor cores' do, then added into a running sum
  rounded to nearest) against one accumulator for all of a row's products;
* the same arithmetic in the backward of ``csrc/lse.cu``
  (``la_row_lse_bwd``): p formed a chunk of columns at a time, then dh and
  dw as 3xTF32 products of p (or p^T) split in registers and the transposed
  w (or h) split, with dh's K ranges and chunks added in order, against
  ``row_lse_bwd_plain`` in float64, and against one accumulator a chunk;
* the tables of ``ops/mel.py:_fft_tables`` driven through the staged
  transform of ``csrc/mel.cu`` (a frame's 400 windowed samples as 200
  complex points, 8 x 25, then the even/odd join) in numpy, against
  ``np.fft.rfft``;
* the Viterbi DP of ``csrc/viterbi.cu`` as its threads run it (states in
  lanes, the shuffled edge states, 2-bit backpointers packed in words and
  flushed in windows, the walk from two prefetched lanes) in numpy, exactly
  equal to ``viterbi_dp_plain`` and the JAX ``_viterbi_dp``.
"""

import math

import numpy as np
import pytest
import torch

from lyricalignment_tpu_torch import HOP_LENGTH, N_FFT
from lyricalignment_tpu_torch.ops import mel
from lyricalignment_tpu_torch.ops.viterbi import LSE_CHUNK, row_lse_bwd_plain


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read it: the low 13 bits of the float32 dropped."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, ties away from zero (the
    kernel's ``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)


def _lse_case(h_scale, rows=64, feat=768, cols=4224, seed=0):
    """The scales of chip_smoke.py's row-LSE check (h ~ 0.5 N(0, 1) there,
    w and b uniform in +-1/sqrt(feat)), a 4224-column slice."""
    rng = np.random.default_rng(seed)
    s = 1.0 / math.sqrt(feat)
    h = torch.from_numpy((rng.standard_normal((rows, feat)) * h_scale).astype(np.float32))
    w = torch.from_numpy(((rng.random((cols, feat)) * 2 - 1) * s).astype(np.float32))
    b = torch.from_numpy(((rng.random(cols) * 2 - 1) * s).astype(np.float32))
    exact = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1)
    return h, w, b, exact


def _holds(got, exact):
    return bool(((got.double() - exact).abs() <= 1e-4 + 1e-5 * exact.abs()).all())


@pytest.mark.parametrize("h_scale", [0.5, 30.0])
def test_three_tf32_products_hold_the_lse_tolerance(h_scale):
    """h.w ~ h_lo.w_hi + h_hi.w_lo + h_hi.w_hi in float32 holds rtol 1e-5 /
    atol 1e-4 of the log-sum-exp, at the smoke run's scales and with h
    scaled by 30 (logits of +-100)."""
    h, w, b, exact = _lse_case(h_scale)
    h_hi, w_hi = _tf32(h), _tf32(w)
    h_lo, w_lo = _tf32_rna(h - h_hi), _tf32_rna(w - w_hi)
    assert torch.equal(_tf32(h_lo), h_lo) and torch.equal(_tf32(w_lo), w_lo)  # read whole
    assert torch.equal(h_hi + (h - h_hi), h) and torch.equal(w_hi + (w - w_hi), w)  # exact split
    logits = (h_lo @ w_hi.T + h_hi @ w_lo.T) + h_hi @ w_hi.T + b
    got = torch.logsumexp(logits, dim=-1)
    assert _holds(got, exact), float((got.double() - exact).abs().max())


def test_one_tf32_product_does_not_hold_it():
    """Without the lo products the same logits miss the tolerance: the
    split is needed."""
    h, w, b, exact = _lse_case(30.0)
    got = torch.logsumexp(_tf32(h) @ _tf32(w).T + b, dim=-1)
    err = float((got.double() - exact).abs().max())
    assert not _holds(got, exact) and err > 1e-3, err


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero (a truncating float32 add)."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _kernel_logits(h, w, group):
    """The kernel's logits as its tensor cores and registers form them: the
    three TF32 products of each k-step of 8 feat (lo . hi, hi . lo, hi . hi)
    added into an accumulator with truncating float32 adds, a fresh
    accumulator every ``group`` products (None: one for the whole row)
    added into a running float32 sum rounded to nearest."""
    h_hi, w_hi = _tf32(h), _tf32(w)
    h_lo, w_lo = _tf32_rna(h - h_hi), _tf32_rna(w - w_hi)
    run = torch.zeros(h.shape[0], w.shape[0], dtype=torch.float32)
    acc = None
    i = 0
    for k in range(0, h.shape[1], 8):
        for a, b in ((h_lo, w_hi), (h_hi, w_lo), (h_hi, w_hi)):
            p = a[:, k:k + 8].double() @ b[:, k:k + 8].double().T
            if acc is not None and group is not None and i % group == 0:
                run = run + acc
                acc = None
            acc = _toward_zero(p if acc is None else acc.double() + p)
            i += 1
    return run + acc


def _aligned_case(top=20.0, rows=8, feat=768, cols=512, seed=3):
    """Rows whose largest logit (about ``top``) is a sum of products of one
    sign, as the largest logits of trained weights are."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(np.abs(rng.standard_normal((rows, feat)) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cols, feat)) / math.sqrt(feat)).astype(np.float32))
    w[:rows] = h / (h ** 2).sum(dim=1, keepdim=True) * top + 0.1 * w[:rows].abs()
    exact = torch.logsumexp(h.double() @ w.double().T, dim=-1)
    return h, w, exact


def test_one_truncating_accumulator_drifts_on_aligned_rows():
    """All 288 products of a row in one accumulator whose adds truncate:
    the lse of such rows is off by more than 5e-5 (what the kernel did
    before it started a fresh accumulator a group)."""
    h, w, exact = _aligned_case()
    err = float((torch.logsumexp(_kernel_logits(h, w, None).double(), -1) - exact).abs().max())
    assert err > 5e-5, err


def test_groups_of_six_hold_aligned_rows():
    """A fresh accumulator every six products, added into a running sum
    rounded to nearest, holds such rows within 1.5e-5 (the card test's
    atol at a top logit of 20)."""
    h, w, exact = _aligned_case()
    err = float((torch.logsumexp(_kernel_logits(h, w, 6).double(), -1) - exact).abs().max())
    assert err <= 1.5e-5, err


def _kernel_bwd(h, w, b, lse, g, group, ranges=1, with_dw=True):
    """(dh, dw, db) as ``la_row_lse_bwd`` forms them, a chunk of LSE_CHUNK
    columns at a time: the p kernel's logits (groups of six), p = g exp(S + b
    - lse) in float32; dh's chunk split into ``ranges`` K ranges of whole
    32-column stages, each range's product (A = p, B = the chunk's w^T) added
    into its own partial in chunk order, the partials summed in range order;
    dw[chunk] = the product of A = p^T and B = h^T; db[chunk] = the row sums
    of p^T. Products by ``_kernel_logits``: a fresh accumulator every
    ``group`` products (None: one for a range's whole K)."""
    parts, dw, db = [None] * ranges, [], []
    for c0 in range(0, w.shape[0], LSE_CHUNK):
        wc, bc = w[c0:c0 + LSE_CHUNK], b[c0:c0 + LSE_CHUNK]
        p = g[:, None] * torch.exp(_kernel_logits(h, wc, 6) + bc - lse[:, None])
        stages = -(-wc.shape[0] // 32)
        for q in range(min(ranges, stages)):
            k0, k1 = 32 * (q * stages // ranges), 32 * ((q + 1) * stages // ranges)
            part = _kernel_logits(p[:, k0:k1], wc[k0:k1].T.contiguous(), group)
            parts[q] = part if parts[q] is None else parts[q] + part
        if with_dw:
            dw.append(_kernel_logits(p.T.contiguous(), h.T.contiguous(), group))
            db.append(p.sum(dim=0))
    dh = parts[0]
    for part in parts[1:]:
        dh = dh + part
    return dh, (torch.cat(dw) if with_dw else None), (torch.cat(db) if with_dw else None)


def _bwd_case(aligned, rows=16, feat=768, cols=LSE_CHUNK + 300, seed=5):
    """Two chunks of columns at the smoke run's scales, or with rows whose p
    sits in one column (``_aligned_case``: a top logit of 20 in column r of
    row r); the float32 lse, g, and the plain backward in float64."""
    if aligned:
        h, w, _ = _aligned_case(rows=rows, feat=feat, cols=cols, seed=seed)
        b = torch.zeros(cols)
    else:
        h, w, b, _ = _lse_case(0.5, rows, feat, cols, seed)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(rows).astype(np.float32))
    lse = torch.logsumexp(h.double() @ w.double().T + b.double(), dim=-1).float()
    ref = row_lse_bwd_plain(h.double(), w.double(), b.double(), lse.double(), g.double())
    return h, w, b, lse, g, ref


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


@pytest.mark.parametrize("ranges", [1, 4])
@pytest.mark.parametrize("aligned", [False, True])
def test_backward_arithmetic_holds_float64(aligned, ranges):
    """The backward's products in 3xTF32 with groups of six, at feat 768 over
    two chunks, hold rel-L2 1e-5 of the float64 plain version in dh, dw and
    db (the card test's tolerance), with dh's chunk in one K range or four."""
    h, w, b, lse, g, ref = _bwd_case(aligned)
    got = _kernel_bwd(h, w, b, lse, g, 6, ranges)
    rels = [_rel(x, want) for x, want in zip(got, ref)]
    assert max(rels) <= 1e-5, rels


def test_one_truncating_accumulator_a_chunk_drifts_in_dh():
    """On rows whose p sits in one column early in the chunk, one accumulator
    for all of a chunk's K (1584 truncating adds, each dropping up to an ulp
    of the large running value) misses rel-L2 1e-5 in dh: the groups of six
    are needed."""
    h, w, b, lse, g, ref = _bwd_case(True)
    top = torch.exp(h.double() @ w[:16].double().T - lse[:, None].double()).diagonal()
    assert float(top.median()) > 0.5
    dh, _, _ = _kernel_bwd(h, w, b, lse, g, None, with_dw=False)
    assert _rel(dh, ref[0]) > 1e-5, _rel(dh, ref[0])


def test_fft_tables_are_float64_values_rounded_once():
    window, twiddle, post = mel._fft_tables(N_FFT)
    assert window.dtype == twiddle.dtype == post.dtype == np.float32
    assert window.shape == (400,) and twiddle.shape == (8, 25, 2) and post.shape == (201, 2)
    n = np.arange(400)
    np.testing.assert_array_equal(
        window, (0.5 * (1.0 - np.cos(2.0 * np.pi * n / 400))).astype(np.float32))
    want = np.exp(-2j * np.pi * np.outer(np.arange(8), np.arange(25)) / 200)
    np.testing.assert_array_equal(twiddle[..., 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(twiddle[..., 1], want.imag.astype(np.float32))
    want = np.exp(-2j * np.pi * np.arange(201) / 400)
    np.testing.assert_array_equal(post[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(post[:, 1], want.imag.astype(np.float32))
    assert twiddle[0].tolist() == [[1.0, 0.0]] * 25 and post[0].tolist() == [1.0, 0.0]


def _staged_rfft(frames: np.ndarray) -> np.ndarray:
    """The kernel's passes on float64 frames [F, 400] with the float32
    tables: returns the 201-bin spectra."""
    window, twiddle, post = mel._fft_tables(N_FFT)
    tw = twiddle[..., 0].astype(np.float64) + 1j * twiddle[..., 1]
    join = post[:, 0].astype(np.float64) + 1j * post[:, 1]
    n1, n2 = mel.FFT_N1, mel.FFT_N2
    xw = frames * window.astype(np.float64)
    z = xw[:, 0::2] + 1j * xw[:, 1::2]                  # [F, 200], n = 25 n1 + n2
    y = np.fft.fft(z.reshape(-1, n1, n2), axis=1)       # pass 1: [F, k1, n2]
    y = np.fft.fft(y * tw, axis=2)                      # pass 2: Z[k1 + 8 k2] at [F, k1, k2]
    k = np.arange(N_FFT // 2 + 1)
    ka, kb = k % 200, (200 - k) % 200
    zk, zc = y[:, ka % n1, ka // n1], np.conj(y[:, kb % n1, kb // n1])
    return (zk + zc) / 2 + join * (zk - zc) / 2j


@pytest.mark.parametrize("n_frames", [8, 7, 1])
@pytest.mark.parametrize("kind", ["noise", "sine"])
def test_staged_transform_matches_rfft(kind, n_frames):
    """The kernel's 8 x 25 split with the even/odd join, on frames
    cut at hop 160 from one signal, against np.fft.rfft of the windowed
    frames: atol 1e-5 of each frame's largest bin."""
    rng = np.random.default_rng(n_frames)
    n = (n_frames - 1) * HOP_LENGTH + N_FFT
    if kind == "noise":
        audio = rng.standard_normal(n)
    else:
        audio = np.sin(2 * np.pi * 1234.5 * np.arange(n) / 16000.0)
    frames = np.stack([audio[f * HOP_LENGTH:f * HOP_LENGTH + N_FFT] for f in range(n_frames)])
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    want = np.fft.rfft(frames * window, axis=-1)
    got = _staged_rfft(frames)
    assert got.shape == (n_frames, 201)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak), float((np.abs(got - want) / peak).max())


def test_staged_transform_keeps_silent_frames_exact():
    """Every frame is transformed on its own, so an all-zero frame gives
    exact zeros (the log's 1e-10 floor) whatever its neighbours hold."""
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((5, N_FFT))
    frames[2] = 0.0
    got = _staged_rfft(frames)
    assert not got[2].any() and got[1].any() and got[3].any()


def test_staged_power_matches_the_plain_version():
    """Power of the staged spectra through the mel filterbank and log10
    against ``log10_mel_plain`` (dense float32 bases): atol 1e-4."""
    rng = np.random.default_rng(5)
    n_frames = 9
    audio = (rng.standard_normal((n_frames - 1) * HOP_LENGTH + N_FFT) * 0.1).astype(np.float32)
    frames = np.stack([audio[f * HOP_LENGTH:f * HOP_LENGTH + N_FFT] for f in range(n_frames)])
    power = np.abs(_staged_rfft(frames.astype(np.float64))) ** 2
    got = np.log10(np.maximum(power @ mel.mel_filterbank(n_mels=80).T.astype(np.float64), 1e-10))
    ref = mel.log10_mel_plain(torch.from_numpy(audio)[None], n_frames, 80)[0].numpy()
    np.testing.assert_allclose(got.T, ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# csrc/viterbi.cu: the DP's lane layout, shuffles, 2-bit packing and the
# windowed backtrace, in numpy
# ---------------------------------------------------------------------------

_NEG_BIG, _NEG_INF = np.float32(-1.0e7), np.float32(-1.0e30)


def _lane_plan(k_dim):
    """(S states a lane, warps a sequence) as ``make_plan`` in
    csrc/viterbi.cu chooses them for K states."""
    s = 2
    while s < 32 and k_dim > 32 * 32 * s:
        s *= 2
    assert k_dim <= 32 * 32 * s
    return s, -(-k_dim // (32 * s))


def _viterbi_layout(lab, sil, labels, nl, nf, window_groups):
    """The kernel's DP one sequence at a time: thread j of the sequence owns
    states [jS, jS + S) of a row in "registers"; its first two states' left
    neighbours are the previous thread's last two (``__shfl_up_sync`` in a
    warp, the published edge across warps), NEG_INF before thread 0; every
    thread of the warp(s) steps, dead ones included; a state's best
    predecessor value is max(p0, p1), or p2 where the skip is allowed and p2
    is at least that. Odd states read the lab
    row at k0/2 + s/2 (k0 = jS is even; a thread past K reads from the row's
    start, and a row's overread runs into the padding), even ones the sil
    value. Codes 0/1/2 pack 2 bits a state, G = 16 / S steps of a lane's S
    states to a 32-bit word, into a window of ``window_groups`` groups,
    flushed to the scratch when full with steps left. The walk keeps the
    state as (lane, slot), reads row u's word from the two lanes it fetched
    for that row a step ahead (the current state's lane and the one before),
    reads the windows back from the last, and writes each state's onset and
    offset as its run of frames ends."""
    bdim, t_max, l_max = lab.shape
    k_dim = 2 * l_max + 1
    S, warps = _lane_plan(k_dim)
    threads = 32 * warps
    lanes, nw = -(-k_dim // S), (2 * S + 31) // 32
    g = 16 // S if S <= 16 else 1
    gw = lanes * nw
    groups = -(-max(t_max - 1, 0) // g)
    wg = min(max(groups, 1), window_groups)
    onset = np.full((bdim, l_max), t_max + 1, np.int32)
    offset = np.zeros((bdim, l_max), np.int32)
    j = np.arange(threads)
    k = j[:, None] * S + np.arange(S)[None, :]                     # [threads, S]
    lab_base = np.where(j * S < k_dim, (j * S) // 2, 0)
    slot = np.arange(S)
    lab_idx = lab_base[:, None] + slot // 2                      # odd slots' entries
    odd_slot = (slot & 1) == 1
    for b in range(bdim):
        live = min(max(int(nf[b]), 0), t_max)
        lab_rows = np.concatenate([lab[b], np.zeros((t_max, 32), np.float32)], 1)
        ids = labels[b]
        dp = np.where(k == 0, sil[b, 0],
                      np.where(k == 1, lab[b, 0, 0], _NEG_BIG)).astype(np.float32)
        skip = ((k & 1) == 1) & (k >= 3) & (k < k_dim) & (
            ids[np.clip(k // 2, 0, l_max - 1)] != ids[np.clip(k // 2 - 1, 0, l_max - 1)])
        bt_s = np.zeros(wg * gw, np.uint32)
        scratch = np.zeros(max(groups, 1) * gw, np.uint32)
        word = np.zeros((threads, nw), np.uint64)
        gp = wi = win = 0
        for t in range(1, live):
            a = np.concatenate([[_NEG_INF], dp[:-1, S - 1]])
            c = np.concatenate([[_NEG_INF], dp[:-1, S - 2]])
            p2 = np.concatenate([c[:, None], a[:, None], dp[:, :S - 2]], 1)
            p1 = np.concatenate([a[:, None], dp[:, :-1]], 1)
            m = np.maximum(dp, p1)                             # the kernel's fmaxf
            sk = skip & (p2 >= m)
            val = np.where(sk, p2, m)
            code = np.where(sk, 2, np.where(dp > p1, 0, 1)).astype(np.uint64)
            em = np.where(odd_slot, lab_rows[t][lab_idx], sil[b, t])
            dp = (val + em).astype(np.float32)                  # one float32 add
            for n in range(nw):
                mine = (2 * slot) // 32 == n
                v = (code[:, mine] << (2 * slot[mine] % 32).astype(np.uint64)).sum(1)
                word[:, n] |= v << np.uint64(gp * 2 * S)
            if gp == g - 1 or t == live - 1:
                for n in range(nw):
                    bt_s[wi * gw + np.arange(lanes) * nw + n] = word[:lanes, n]
                word[:] = 0
                if gp == g - 1:
                    wi += 1
                    if wi == wg and t < live - 1:
                        scratch[win * wg * gw:(win + 1) * wg * gw] = bt_s
                        win, wi = win + 1, 0
            gp = 0 if gp == g - 1 else gp + 1
        if live == 0:
            continue
        flat = dp.reshape(-1)
        ends = [2 * int(nl[b]), 2 * int(nl[b]) - 1]
        i_sil, i_lab = (min(max(i + k_dim if i < 0 else i, 0), k_dim - 1) for i in ends)
        cur = i_sil if flat[i_sil] > flat[i_lab] else i_lab
        lane_c, slot_c = divmod(cur, S)
        run_end, n_steps = live - 1, live - 1
        last_win = (n_steps - 1) // g // wg if n_steps > 0 else -1

        def fetch(u, ln, w):  # row u's words of lanes ln and ln - 1
            q = (u // g - w * wg) * gw
            return ([int(bt_s[q + ln * nw + n]) for n in range(nw)],
                    [int(bt_s[q + max(ln - 1, 0) * nw + n]) for n in range(nw)])

        for w in range(last_win, -1, -1):
            if w != last_win:
                bt_s = scratch[w * wg * gw:(w + 1) * wg * gw].copy()
            u_lo, u_hi = w * wg * g, min(n_steps, (w + 1) * wg * g) - 1
            fetched_lane, (here, below) = lane_c, fetch(u_hi, lane_c, w)
            for u in range(u_hi, u_lo - 1, -1):
                ahead = (lane_c, fetch(u - 1, lane_c, w) if u > u_lo else None)
                bit = 2 * ((u % g) * S + slot_c)
                words = here if lane_c == fetched_lane else below
                code = (words[bit // 32] >> (bit % 32)) & 3
                assert cur == lane_c * S + slot_c and lane_c >= fetched_lane - 1
                if code:
                    if cur & 1:
                        onset[b, cur >> 1], offset[b, cur >> 1] = u + 1, run_end + 1
                    run_end, cur = u, cur - code
                    lane_c, slot_c = divmod(cur, S)
                if ahead[1] is not None:
                    fetched_lane, (here, below) = ahead[0], ahead[1]
        if cur & 1:
            onset[b, cur >> 1], offset[b, cur >> 1] = 0, run_end + 1
    return onset, offset


def _viterbi_case(l_max, kind, frames=41, bdim=5, seed=0):
    rng = np.random.default_rng(seed + l_max)
    if kind == "ties":   # every emission equal: the tie rules decide
        lab = np.full((bdim, frames, l_max), -1.5, np.float32)
        sil = np.full((bdim, frames), -1.5, np.float32)
    else:
        logp = rng.standard_normal((bdim, frames, l_max + 1)) * 3
        logp = np.maximum(logp - np.log(np.exp(logp).sum(-1, keepdims=True)), -1000.0)
        lab, sil = logp[..., :l_max].astype(np.float32), logp[..., l_max].astype(np.float32)
    hi = 3 if kind == "repeats" else 400
    labels = rng.integers(1, hi, (bdim, l_max)).astype(np.int32)
    nl = np.array([l_max, 0, l_max // 2 + 1, 1, l_max], np.int32)[:bdim]
    nf = np.array([frames, 1, 0, frames + 5, frames // 2], np.int32)[:bdim]
    return lab, sil, labels, nl, nf


# K = 31 / 33 / 95 / 97 / 257 / 501 / 601 / 2001: S = 2 on 1 / 2 / 2 / 2 / 5 / 8 /
# 10 / 32 warps; K = 2201 / 5001 / 10001: S = 4 / 8 / 16 on 18 / 20 / 20 warps;
# K = 16601: S = 32 (two words a lane a step) on 17 warps
@pytest.mark.parametrize("window", ["fits", "flushed"])
@pytest.mark.parametrize("kind", ["random", "ties", "repeats"])
@pytest.mark.parametrize("l_max", [15, 16, 47, 48, 128, 250, 300, 1000, 1100, 2500, 5000,
                                   8300])
def test_viterbi_layout_matches_plain_and_jax(l_max, kind, window):
    """The layout's onsets and offsets equal ``viterbi_dp_plain``'s and the
    JAX ``_viterbi_dp``'s exactly, with the whole backtrace in one window
    and with windows of two groups flushed and read back."""
    import jax
    import jax.numpy as jnp

    from lyricalignment_tpu.ops import viterbi as jv
    from lyricalignment_tpu_torch.ops.viterbi import viterbi_dp_plain

    # 17 frames above 2048 states (S >= 4: still 4 or more groups of steps)
    case = _viterbi_case(l_max, kind, frames=41 if l_max <= 1000 else 17)
    got = _viterbi_layout(*case, window_groups=10 ** 9 if window == "fits" else 2)
    plain = viterbi_dp_plain(*(torch.from_numpy(x) for x in case))
    ref = jax.vmap(jv._viterbi_single_pos)(*(jnp.asarray(x) for x in case))
    for g, p, r in zip(got, plain, ref):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, np.asarray(r))


def test_viterbi_lane_plan():
    """Two states a lane (a walk step then stays within two lanes) on
    ceil(K / 64) warps up to 32 warps; larger K doubles the states a lane
    (4, 8, 16, 32) until 32 warps hold them."""
    assert [_lane_plan(k) for k in (3, 31, 64, 65, 97, 257, 511, 512, 2048)] == [
        (2, 1), (2, 1), (2, 1), (2, 2), (2, 2), (2, 5), (2, 8), (2, 8), (2, 32)]
    assert _lane_plan(2049) == (4, 17) and _lane_plan(4097) == (8, 17)
    assert _lane_plan(8193) == (16, 17) and _lane_plan(16384) == (16, 32)
    assert _lane_plan(16385) == (32, 17) and _lane_plan(32768) == (32, 32)
