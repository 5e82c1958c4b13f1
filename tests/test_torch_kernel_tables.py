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
  equal to ``viterbi_dp_plain`` and the JAX ``_viterbi_dp``;
* the reduced CTC pair of ``csrc/ctc.cu`` as its lanes run it (K states a
  lane, the edge states shuffled or published, the backward's ``_lse3``
  weights computed first, then the linear adjoint recurrence of FMAs and
  d blank_lp summed in the kernel's order) in numpy float32, against
  ``ctc_reduced_fwd_plain`` / ``_bwd_plain`` and ``jax.grad`` of
  ``jax.vmap(_ctc_nll_single)``.
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


# ---------------------------------------------------------------------------
# The reduced CTC pair of csrc/ctc.cu: states in lanes, the backward's
# weights off the chain, in numpy float32
# ---------------------------------------------------------------------------

_CTC_NEG = np.float32(-1.0e30)
_F32 = np.float32


def _ctc_plan(s_dim, k=4):
    """(states a lane, warps, lanes that own states, padded states) as
    ``make_plan`` in csrc/ctc.cu lays out S states at K = ``k`` (each
    chain has its own K)."""
    warps = -(-s_dim // (32 * k))
    assert warps <= 32
    return k, warps, -(-s_dim // k), 32 * warps * k


def _lse3(a0, a1, a2):
    m = np.maximum(np.maximum(a0, a1), a2)
    return m + np.log(np.exp(a0 - m) + np.exp(a1 - m) + np.exp(a2 - m))


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32 (up to
    the rare double rounding of the sum)."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def _ctc_states(labels, valid, s_pad):
    """Per padded state: odd, label position (clamped), live (a real state
    whose emission is not the sentinel), may skip."""
    n = labels.shape[0]
    s_dim = 2 * n + 1
    s = np.arange(s_pad)
    odd = (s & 1) == 1
    pos = np.minimum(s >> 1, n - 1)
    live = (s < s_dim) & (~odd | valid[pos])
    skip = odd & (s >= 3) & (s < s_dim) & (labels[pos] != labels[np.maximum(pos - 1, 0)])
    return odd, pos, live, skip


def _ctc_fwd_lanes(blank, label, labels, valid, k=4):
    """The forward as ``ctc_fwd_kernel`` steps: thread j's K states in
    "registers" [warps, 32, K]; a slot's states s - 1 and s - 2 from its own
    lower slots, or (the lowest two) ``__shfl_up_sync`` from the lane below,
    or on a warp's lane 0 (and lane 1 at K = 1) the edges the warp below
    published, the sentinel below warp 0; every slot steps, the dead ones
    (past S, invalid positions) with the sentinel emission. -> (nll,
    alphas) as float32."""
    bdim, t_max, n = label.shape
    s_dim = 2 * n + 1
    _, warps, _, s_pad = _ctc_plan(s_dim, k)
    nll = np.zeros(bdim, _F32)
    alphas = np.zeros((bdim, t_max, s_dim), _F32)
    for b in range(bdim):
        odd, pos, live, skip = (x.reshape(warps, 32, k)
                                for x in _ctc_states(labels[b], valid[b], s_pad))

        def emission(t):
            return np.where(~live, _CTC_NEG, np.where(odd, label[b, t][pos], blank[b, t]))

        s = np.arange(s_pad).reshape(warps, 32, k)
        a = np.where(s < 2, emission(0), _CTC_NEG).astype(_F32)
        alphas[b, 0] = a.reshape(-1)[:s_dim]
        for t in range(1, t_max):
            # the edges: each warp's two highest states, to the warp above
            top1 = a[:, 31, k - 1]
            top2 = a[:, 31, k - 2] if k >= 2 else a[:, 30, 0]
            edge1 = np.concatenate([[_CTC_NEG], top1[:-1]])
            edge2 = np.concatenate([[_CTC_NEG], top2[:-1]])
            below1 = np.roll(a[:, :, k - 1], 1, axis=1)
            below2 = np.roll(a[:, :, k - 2], 1, axis=1) if k >= 2 else np.roll(a[:, :, 0], 2, axis=1)
            below1[:, 0], below2[:, 0] = edge1, edge2
            if k == 1:
                below2[:, 1] = edge1
            em = emission(t)
            new = np.empty_like(a)
            for i in range(k - 1, -1, -1):
                a1 = a[:, :, i - 1] if i >= 1 else below1
                a2 = a[:, :, i - 2] if i >= 2 else (below1 if i == 1 else below2)
                a2 = np.where(skip[:, :, i], a2, _CTC_NEG)
                new[:, :, i] = em[:, :, i] + _lse3(a[:, :, i], a1, a2)
            a = new
            alphas[b, t] = a.reshape(-1)[:s_dim]
        tlen = int(valid[b].sum())
        flat = a.reshape(-1)
        end_lab = flat[2 * tlen - 1] if tlen > 0 else _CTC_NEG
        end_blank = flat[2 * tlen]
        m = max(end_lab, end_blank)
        nll[b] = -(m + np.log(np.exp(end_lab - m) + np.exp(end_blank - m)))
    return nll, alphas


def _ctc_weights(alpha_prev, skip, s_dim, s_pad):
    """``ctc_bwd_weights_kernel`` for one frame t: rows u0, u1, u2 [s_pad]
    over frame t - 1's alphas (``skip`` [s_pad]: the states that may skip),
    zeros past S (and u2 where s + 2 may not skip)."""
    a = np.full(s_pad + 2, _CTC_NEG, _F32)
    a[:s_dim] = alpha_prev
    x = np.arange(s_pad + 2)
    a1 = np.concatenate([[_CTC_NEG], a[:-1]])
    a2 = np.where(np.concatenate([skip, [False, False]]),
                  np.concatenate([[_CTC_NEG, _CTC_NEG], a[:-2]]), _CTC_NEG)
    m = np.maximum(np.maximum(a, a1), a2)
    total = np.exp(a - m) + np.exp(a1 - m) + np.exp(a2 - m)
    real = x < s_dim
    av = a[:s_pad]
    u0 = np.where(real[:s_pad], np.exp(av - m[:s_pad]) / total[:s_pad], 0)
    u1 = np.where(real[1:s_pad + 1], np.exp(av - m[1:s_pad + 1]) / total[1:s_pad + 1], 0)
    skip2 = np.concatenate([skip, [False, False]])[2:]
    u2 = np.where(skip2, np.exp(np.where(skip2, av - m[2:], 0)) / total[2:], 0)
    return np.stack([u0, u1, u2]).astype(_F32)


def _ctc_bwd_lanes(alphas, labels, valid, g, k=4, weights=_ctc_weights):
    """The backward as ``la_ctc_reduced_bwd`` runs it: every frame's
    weights first (``weights``), then the chain from the end states' adjoint:
    frame t's emission adjoints out (d label_lp from the odd states, each
    lane's even states summed in order), then adj_{t-1} = fma(u2, x2,
    fma(u1, x1, u0 adj)) with the states s + 1 and s + 2 from the lane's own
    higher slots, ``__shfl_down_sync`` from the lane above or the edges the
    warp above published (0 above the last warp); d blank_lp[t] sums the
    lanes' partials into four sums by lane mod 4, each in lane order, then
    (0 + 1) + (2 + 3). -> (d_blank, d_label) as float32."""
    bdim, t_max, s_dim = alphas.shape
    n = labels.shape[1]
    _, warps, lanes, s_pad = _ctc_plan(s_dim, k)
    d_blank = np.zeros((bdim, t_max), _F32)
    d_label = np.zeros((bdim, t_max, n), _F32)
    for b in range(bdim):
        odd, pos, live, skip = _ctc_states(labels[b], valid[b], s_pad)
        w = np.stack([np.zeros((3, s_pad), _F32)]
                     + [weights(alphas[b, t - 1], skip, s_dim, s_pad)
                        for t in range(1, t_max)])
        tlen = int(valid[b].sum())
        last = alphas[b, -1]
        end_lab = last[2 * tlen - 1] if tlen > 0 else _CTC_NEG
        end_blank = last[2 * tlen]
        m = max(end_lab, end_blank)
        e_lab, e_blank = np.exp(end_lab - m), np.exp(end_blank - m)
        gs = _F32(g[b]) / (e_lab + e_blank)
        adj = np.zeros(s_pad, _F32)
        adj[2 * tlen] = -gs * e_blank
        if tlen > 0:
            adj[2 * tlen - 1] = -gs * e_lab

        def emit(t, first):
            on = live & ((not first) | (np.arange(s_pad) < 2))
            v = np.where(on, adj, _F32(0)).astype(_F32)
            real_odd = odd & (np.arange(s_pad) < s_dim)
            d_label[b, t, pos[real_odd]] = v[real_odd]
            ev = np.where(odd, _F32(0), v).reshape(-1, k)
            part = np.zeros(ev.shape[0], _F32)
            for i in range(k):       # a lane's even states in order
                part = (part + ev[:, i]).astype(_F32)
            return part

        for t in range(t_max - 1, 0, -1):
            part = emit(t, False)
            q = [_F32(0)] * 4           # four sums by lane mod 4, in lane order
            for lane in range(lanes):
                q[lane % 4] = _F32(q[lane % 4] + part[lane])
            d_blank[b, t] = _F32(_F32(q[0] + q[1]) + _F32(q[2] + q[3]))
            lane_adj = adj.reshape(warps * 32, k)
            above1 = np.concatenate([lane_adj[1:, 0], [0]]).astype(_F32)
            above2 = (np.concatenate([lane_adj[1:, 1], [0]]) if k >= 2
                      else np.concatenate([lane_adj[2:, 0], [0, 0]])).astype(_F32)
            u0, u1, u2 = (x.reshape(-1, k) for x in w[t])
            new = np.empty_like(lane_adj)
            for i in range(k):
                x1 = lane_adj[:, i + 1] if i + 1 < k else above1
                x2 = lane_adj[:, i + 2] if i + 2 < k else (above1 if i + 2 == k else above2)
                new[:, i] = _fma(u2[:, i], x2, _fma(u1[:, i], x1, (u0[:, i] * lane_adj[:, i])))
            adj = new.reshape(-1)
        d_blank[b, 0] = emit(0, True)[0]
    return d_blank, d_label


def _ctc_case_np(t, n, seed, kinds):
    """Reduced emissions and targets as tests/test_torch_cuda.py's
    ``_ctc_case`` makes them, from numpy."""
    rng = np.random.default_rng(seed)
    bdim = len(kinds)
    blank = (rng.standard_normal((bdim, t)) - 2).astype(_F32)
    label = (rng.standard_normal((bdim, t, n)) - 2).astype(_F32)
    labels = rng.integers(1, 50, (bdim, n)).astype(np.int32)
    valid = np.zeros((bdim, n), bool)
    for i, kind in enumerate(kinds):
        kk = {"random": n // 2, "repeats": n // 2, "empty": 0, "full": n, "infeasible": n}[kind]
        valid[i, :kk] = True
        if kind == "repeats":
            labels[i, 1:kk:2] = labels[i, 0:kk - 1:2]
    return blank, label, labels, valid


def _jax_ctc(blank, label, labels, valid, g):
    import jax
    import jax.numpy as jnp

    from lyricalignment_tpu.train import losses as J

    def f(bl, ll):
        return jax.vmap(J._ctc_nll_single)(bl, ll, jnp.asarray(labels), jnp.asarray(valid))

    nll = np.asarray(f(blank, label))
    grads = jax.grad(lambda a, b: jnp.sum(f(a, b) * g), argnums=(0, 1))(blank, label)
    return nll, [np.asarray(x) for x in grads]


def _rel_np(a, b):
    return float(np.linalg.norm(a.astype(np.float64) - b) / max(np.linalg.norm(b), 1e-30))


# S = 3 / 7 / 11 / 31 / 33 / 97 / 129 / 1023: at K = 4 one warp up to S = 128,
# then 2 and 8 warps (the edges cross warps); K = 1 and 2 are the plans the
# variants time
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("t,n", [(1, 1), (2, 3), (7, 5), (9, 15), (9, 16), (6, 48), (5, 64),
                                 (3, 511)])
def test_ctc_lane_model_matches_plain_and_jax(t, n, k):
    """The lane model of the forward and of the backward (weights first,
    then the linear recurrence, d blank_lp in the kernel's order) against
    the plain recursions and ``jax.vmap(_ctc_nll_single)`` with its
    ``jax.grad``: NLL rtol 1e-5, gradients rel-L2 1e-5, for a random, a
    repeated, an all-padding and a full target (one that cannot fit where
    2N exceeds T)."""
    from lyricalignment_tpu_torch.ops import ctc

    kinds = ["random", "repeats", "empty", "infeasible" if 2 * n > t else "full"]
    blank, label, labels, valid = _ctc_case_np(t, n, 17 * t + n, kinds)
    g = np.random.default_rng(t).standard_normal(4).astype(_F32)
    nll, alphas = _ctc_fwd_lanes(blank, label, labels, valid, k)
    grads = _ctc_bwd_lanes(alphas, labels, valid, g, k)
    tt = [torch.from_numpy(x) for x in (blank, label, labels, valid)]
    ref_nll, ref_alphas = ctc.ctc_reduced_fwd_plain(*tt)
    ref_grads = ctc.ctc_reduced_bwd_plain(ref_alphas, tt[2], tt[3], torch.from_numpy(g))
    jax_nll, jax_grads = _jax_ctc(blank, label, labels, valid, g)
    np.testing.assert_allclose(nll, ref_nll.numpy(), rtol=1e-5)
    np.testing.assert_allclose(nll, jax_nll, rtol=1e-5)
    np.testing.assert_allclose(alphas, ref_alphas.numpy(), rtol=1e-5, atol=1e-4)
    for got, plain, want in zip(grads, ref_grads, jax_grads):
        assert _rel_np(got, plain.numpy()) <= 1e-5
        assert _rel_np(got, want) <= 1e-5


def _shortcut_weights(alpha_prev, skip, s_dim, s_pad, em_t, alpha_t):
    """The weights as exp(a_j - (alpha_t[s] - em_t[s])): equal to exp(a_j -
    m) / sum in real arithmetic, not at the sentinel."""
    a = np.full(s_pad + 2, _CTC_NEG, _F32)
    a[:s_dim] = alpha_prev
    lse = np.full(s_pad + 2, _CTC_NEG, _F32)
    lse[:s_dim] = alpha_t - em_t
    av = a[:s_pad]
    real = np.arange(s_pad + 2) < s_dim
    u0 = np.where(real[:s_pad], np.exp(av - lse[:s_pad]), 0)
    u1 = np.where(real[1:s_pad + 1], np.exp(av - lse[1:s_pad + 1]), 0)
    skip2 = np.concatenate([skip, [False, False]])[2:]
    u2 = np.where(skip2, np.exp(np.where(skip2, av - lse[2:], 0)), 0)
    return np.stack([u0, u1, u2]).astype(_F32)


def test_ctc_sentinel_weights_are_a_third_each():
    """A target that cannot fit (N = 4 labels in T = 3 frames): at frame 1
    state 4's three inputs are all the sentinel, and its weights are 1/3
    each, as jax.grad gives them; the shortcut exp(a_j - (alpha_t - em_t))
    gives 1 each there (-1e30 + log 3 rounds to -1e30), and with it the
    backward leaves jax.grad, while the kernel's weights hold it."""
    blank, label, labels, valid = _ctc_case_np(3, 4, 5, ["infeasible", "random"])
    labels[0] = [3, 7, 9, 11]
    g = np.array([1.0, 0.5], _F32)
    nll, alphas = _ctc_fwd_lanes(blank, label, labels, valid)
    assert nll[0] > 1e29
    s_dim = 9
    _, _, _, s_pad = _ctc_plan(s_dim)
    _, pos, _, skip = _ctc_states(labels[0], valid[0], s_pad)
    w = _ctc_weights(alphas[0, 0], skip, s_dim, s_pad)
    third = _F32(1) / _F32(3)
    # state 4 reads states 4 (u0[4]), 3 (u1[3]) and, unable to skip (blank),
    # its third input is the sentinel itself
    assert w[0, 4] == third and w[1, 3] == third
    # state 5 (label 2, may skip) reads 5, 4 and 3: all the sentinel
    assert w[0, 5] == third and w[1, 4] == third and w[2, 3] == third
    em = np.where((np.arange(s_dim) & 1) == 1, label[0, 1][pos[:s_dim]], blank[0, 1])
    short = _shortcut_weights(alphas[0, 0], skip, s_dim, s_pad, em, alphas[0, 1])
    assert short[0, 4] == 1 and short[1, 3] == 1 and short[2, 3] == 1
    _, jax_grads = _jax_ctc(blank, label, labels, valid, g)

    def shortcut(alpha_prev, skip_, s_dim_, s_pad_):
        t = next(t for t in range(1, alphas.shape[1])
                 if np.array_equal(alphas[0, t - 1], alpha_prev))
        e = np.where((np.arange(s_dim_) & 1) == 1, label[0, t][pos[:s_dim_]], blank[0, t])
        return _shortcut_weights(alpha_prev, skip_, s_dim_, s_pad_, e, alphas[0, t])

    good = _ctc_bwd_lanes(alphas[:1], labels[:1], valid[:1], g[:1])
    bad = _ctc_bwd_lanes(alphas[:1], labels[:1], valid[:1], g[:1], weights=shortcut)
    for got, broken, want in zip(good, bad, jax_grads):
        assert _rel_np(got, want[:1]) <= 1e-5
        assert _rel_np(broken, want[:1]) > 1e-2


def test_ctc_lane_plan():
    """K states a lane in ceil(S / 32K) warps, the padded states (a weight
    row's stride) 32 K warps: at K = 4 one warp up to S = 128 (N = 63),
    8 at N = 511; K = 2 needs 16 warps there and K = 1 32, the most a
    block holds."""
    assert [_ctc_plan(s) for s in (3, 31, 33, 97, 127, 129, 1023)] == [
        (4, 1, 1, 128), (4, 1, 8, 128), (4, 1, 9, 128), (4, 1, 25, 128), (4, 1, 32, 128),
        (4, 2, 33, 256), (4, 8, 256, 1024)]
    assert _ctc_plan(97, 2) == (2, 2, 49, 128) and _ctc_plan(97, 1) == (1, 4, 97, 128)
    assert _ctc_plan(1023, 2) == (2, 16, 512, 1024) and _ctc_plan(1023, 1) == (1, 32, 1023, 1024)
