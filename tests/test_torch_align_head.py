"""Port align head (bi-GRU -> Mish, + fc) vs the JAX scan head, with ragged
lengths: at valid frames the port must equal the JAX masked scan to
float32 rounding (atol 1e-5), on both of its routes (grad disabled: the
recurrence's plain version, the kernel's arithmetic on the CPU; grad
enabled: ``nn.GRU``, packed). The plain recurrence is also held to
``nn.GRU`` itself, and the route to the grad mode through the head's
counters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from lyricalignment_tpu.models.align_head import align_head_apply as jax_apply
from lyricalignment_tpu.models.align_head import align_head_hidden as jax_hidden
from lyricalignment_tpu_torch.models.align_head import align_head_apply, align_head_hidden
from lyricalignment_tpu_torch.models.align_model import forward_from_audio
from lyricalignment_tpu_torch.ops.gru import bigru_apply
from lyricalignment_tpu_torch.utils import observability
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("lengths", [None, [50, 31, 7]])
def test_align_head_matches_jax(rng, lengths, grad):
    cfg, params = jax_tiny_model()
    x = rng.standard_normal((3, 50, 64)).astype(np.float32)
    head = as_jax(params)["align_head"]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    model = torch_model(cfg, params)
    mode = torch.enable_grad() if grad else torch.inference_mode()
    with mode:
        hid = align_head_hidden(model.align_rnn, torch.from_numpy(x), tl).detach()
        logits = align_head_apply(model.align_rnn, torch.from_numpy(x), tl).detach()
    ref_hid = np.asarray(jax_hidden(head, jnp.asarray(x), lengths=jl))
    ref_logits = np.asarray(jax_apply(head, jnp.asarray(x), lengths=jl))
    assert hid.dtype == torch.float32 and hid.shape == (3, 50, 32)
    for b, n in enumerate(lengths or [50] * 3):
        np.testing.assert_allclose(hid.numpy()[b, :n], ref_hid[b, :n], atol=1e-5, rtol=0)
        np.testing.assert_allclose(logits.numpy()[b, :n], ref_logits[b, :n],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("hidden", [6, 16, 32])
def test_gru_recurrence_plain_matches_nn_gru(hidden, ragged, bidirectional):
    """Grad disabled on the CPU runs the recurrence's plain version; it must
    give what packed ``nn.GRU`` gives at valid frames (float32 sums in
    another order: atol 1e-5) and exact zeros past each length."""
    torch.manual_seed(hidden)
    b, t, n_in = 4, 23, 12
    rnn = nn.GRU(n_in, hidden, num_layers=2, bidirectional=bidirectional, batch_first=True)
    x = torch.randn(b, t, n_in)
    lengths = [t, 1, 9, 17] if ragged else [t] * b  # a row of length 1 and one of T
    with torch.no_grad():
        got = bigru_apply(rnn, x, torch.tensor(lengths) if ragged else None)
        if ragged:
            packed = pack_padded_sequence(x, torch.tensor(lengths), batch_first=True,
                                          enforce_sorted=False)
            want = pad_packed_sequence(rnn(packed)[0], batch_first=True, total_length=t)[0]
        else:
            want = rnn(x)[0]
    assert got.shape == want.shape == (b, t, hidden * (2 if bidirectional else 1))
    for i, n in enumerate(lengths):
        torch.testing.assert_close(got[i, :n], want[i, :n], atol=1e-5, rtol=0)
        assert torch.equal(got[i, n:], torch.zeros_like(got[i, n:]))


def test_gru_route_follows_the_grad_mode(rng):
    """Grad enabled keeps nn.GRU (the training step's backward needs it),
    grad disabled takes the recurrence kernel's route: the head's counters
    say which, a layer each, and both routes agree at valid frames."""
    cfg, params = jax_tiny_model()
    model = torch_model(cfg, params)
    n_layers = model.align_rnn.rnn.num_layers
    audio = torch.from_numpy(rng.standard_normal((2, 16000)).astype(np.float32) * 0.1)
    frames = torch.tensor([50, 20])
    hidden = {}
    for grad in (True, False):
        observability.reset_counts()
        with torch.set_grad_enabled(grad):
            hidden[grad], _ = forward_from_audio(model, audio, frame_lengths=frames,
                                                 align_head_output="hidden")
        counts = dict(observability.counts)
        assert counts.get("head.gru_cudnn_layers", 0) == (n_layers if grad else 0)
        assert counts.get("head.gru_kernel_layers", 0) == (0 if grad else n_layers)
    observability.reset_counts()
    assert hidden[True].requires_grad and not hidden[False].requires_grad
    for i, n in enumerate(frames.tolist()):
        torch.testing.assert_close(hidden[False][i, :n], hidden[True][i, :n].detach(),
                                   atol=1e-5, rtol=0)
