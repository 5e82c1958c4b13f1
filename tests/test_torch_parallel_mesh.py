"""The port's mesh module (``parallel/mesh.py``) on gloo ranks spawned on
the CPU: ``make_mesh``'s shapes and errors (JAX ``mesh.py:36-42``), the
rank -> coordinate layout, the spec table against JAX's
``align_param_specs`` leaf by leaf, ``shard_align_params`` then the
checkpoint gather bit for bit (an indivisible model stays replicated), the
Megatron f / g operators and the gather against autograd on the unsharded
linears, and the sequence-parallel encode over two ranks against the
single-device JAX ``encode_audio`` at JAX's own tolerance
(``tests/test_trainer.py:165``), with its refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyricalignment_tpu.models.whisper import encode_audio as jax_encode_audio
from lyricalignment_tpu.parallel.mesh import align_param_specs as jax_align_param_specs
from lyricalignment_tpu_torch.models.convert import state_dict_from_jax_params
from lyricalignment_tpu_torch.parallel.mesh import (
    COLUMN,
    REPLICATED,
    ROW,
    VOCAB,
    align_param_specs,
    mesh_shape,
)
from tests import torch_parallel_helpers as tph
from tests.torch_port_helpers import as_jax, jax_tiny_model, torch_model

# head dim 64, as every Whisper size has it
DIMS = dict(n_audio_state=256, n_audio_head=4, n_audio_layer=1, n_text_state=256,
            n_text_head=4, n_text_layer=1, n_vocab=64)
# 3 heads over 2 ranks and an odd vocabulary: attention and embedding stay
# replicated, the MLP (4 x 192) is sharded
DIMS_IND = dict(n_audio_state=192, n_audio_head=3, n_audio_layer=1, n_text_state=192,
                n_text_head=3, n_text_layer=1, n_vocab=51)


def test_mesh_shape_and_errors():
    assert mesh_shape(-1, 1, 8) == (8, 1)
    assert mesh_shape(-1, 2, 8) == (4, 2)
    assert mesh_shape(2, 4, 8) == (2, 4)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        mesh_shape(-1, 3, 8)
    with pytest.raises(ValueError, match=r"mesh 3x1 != 8 devices"):
        mesh_shape(3, 1, 8)


def _coded(leaf, spec):
    """A leaf's shape with values that vary only along its model-sharded
    dim (zeros for a replicated leaf)."""
    shape = np.shape(leaf)
    dims = [i for i, axis in enumerate(spec) if axis == "model"]
    if not dims:
        return np.zeros(shape, np.float32)
    d = dims[0]
    idx = np.arange(shape[d], dtype=np.float32).reshape([-1 if i == d else 1
                                                         for i in range(len(shape))])
    return np.broadcast_to(idx + 1.0, shape).copy()


def _kind(name, t):
    varying = [d for d in range(t.dim()) if t.shape[d] > 1 and
               not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
    if not varying:
        return REPLICATED
    assert len(varying) == 1, name
    if name.endswith("token_embedding.weight"):
        return VOCAB
    return COLUMN if varying[0] == 0 else ROW


def test_spec_table_matches_jax():
    """Each JAX leaf, coded along its sharded dim, goes through the port's
    converter; the dim the values vary along in the port's layout is the
    kind the port's table must give. The conv stem is the recorded
    difference: JAX shards its output channels, the port replicates it."""
    cfg, params = jax_tiny_model(dims=DIMS)
    specs = jax_align_param_specs(params, tp=True)
    coded = jax.tree_util.tree_map(_coded, params, specs,
                                   is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    converted = state_dict_from_jax_params(coded, n_audio_ctx=cfg.whisper.n_audio_ctx)
    ours = align_param_specs(torch_model(cfg, params))
    assert set(converted) == set(ours)
    kinds = {}
    for name, t in converted.items():
        if name == "whisper_model.encoder.positional_embedding":
            assert ours[name] == REPLICATED  # a buffer, not a JAX parameter
            continue
        want = _kind(name, t)
        if ".conv" in name:
            assert want == COLUMN and ours[name] == REPLICATED, name
            continue
        assert ours[name] == want, name
        kinds[want] = kinds.get(want, 0) + 1
    # q/k/v weights and q/v biases of 3 attentions and both fc1 leaves of 2
    # MLPs; 3 outs and 2 fc2s; the vocabulary
    assert kinds[COLUMN] == 3 * 5 + 2 * 2 and kinds[ROW] == 3 + 2 and kinds[VOCAB] == 1
    assert all(v == REPLICATED for k, v in ours.items() if k.startswith("align_rnn."))


def _payload():
    """(what the ranks get, the JAX reference's params and config)."""
    rng = np.random.default_rng(3)
    payload = {}
    for key, dims in (("div", DIMS), ("ind", DIMS_IND)):
        model = torch_model(*jax_tiny_model(dims=dims, output_dim=13))
        payload[key] = (model.cfg, tph.numpy_dict(model.state_dict()))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    payload["linear"] = (f(3, 5, 8), f(12, 8), f(12), f(8, 12), f(8), f(3, 5, 8), f(3, 5, 12))
    cfg, params = jax_tiny_model(dims=DIMS)
    whisper = torch_model(cfg, params).whisper_model
    payload["sp"] = (whisper.cfg, tph.numpy_dict(whisper.state_dict()), f(2, 80, 3000))
    ind = torch_model(*jax_tiny_model(dims=DIMS_IND)).whisper_model
    payload["sp_heads3"] = (ind.cfg, tph.numpy_dict(ind.state_dict()))
    return payload, (params["whisper"], cfg.whisper)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    payload, jax_ref = _payload()
    ranks = tph.run_ranks(tph.mesh_checks, 2, tmp_path_factory.mktemp("mesh"), payload)
    return payload, jax_ref, ranks


@pytest.mark.parametrize("key", ["div", "ind"])
def test_shard_then_gather_is_bit_exact(world2, key):
    payload, _, ranks = world2
    _, full = payload[key]
    for rank, out in enumerate(ranks):
        res = out[key]
        assert set(res["gathered"]) == set(full)
        for name, value in full.items():
            np.testing.assert_array_equal(res["gathered"][name], value, err_msg=name)
        for name, kind in res["specs"].items():
            dim = {COLUMN: 0, ROW: 1, VOCAB: 0}[kind]
            want = list(full[name].shape)
            want[dim] //= 2
            assert res["shapes"][name] == tuple(want), name
    div, ind = ranks[0]["div"], ranks[0]["ind"]
    if key == "div":
        assert div["heads"] == [2] and ranks[1]["div"]["vocab_start"] == 32
        assert "whisper_model.decoder.token_embedding.weight" in div["specs"]
    else:
        # 3 heads and a vocabulary of 51 do not divide 2: replicated; the
        # MLP (4 x 192) is sharded
        assert ind["heads"] == [3] and ind["vocab_start"] == 0
        assert not any(".attn." in k or "token_embedding" in k for k in ind["specs"])
        assert ind["specs"]["whisper_model.encoder.blocks.0.mlp.0.weight"] == COLUMN


def test_megatron_operators_match_autograd(world2):
    """z = g(gelu(f(x) W1_r^T + b1_r) W2_r^T) + b2 summed over the two
    ranks' halves of the hidden, and the gathered hidden, against the same
    on the unsharded weights: values and every gradient."""
    payload, _, ranks = world2
    x_np, w1, b1, w2, b2, g_out, g_gather = payload["linear"]
    x = torch.tensor(x_np, requires_grad=True)
    tw = [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2, b2)]
    y = torch.nn.functional.gelu(torch.nn.functional.linear(x, tw[0], tw[1]))
    z = torch.nn.functional.linear(y, tw[2], tw[3])
    ((z * torch.tensor(g_out)).sum() + (y * torch.tensor(g_gather)).sum()).backward()
    for rank, out in enumerate(ranks):
        fg = out["fg"]
        rows = slice(rank * 6, (rank + 1) * 6)
        np.testing.assert_allclose(fg["z"], z.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fg["full"], y.detach().numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(fg["dx"], x.grad.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fg["dw1"], tw[0].grad.numpy()[rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fg["db1"], tw[1].grad.numpy()[rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fg["dw2"], tw[2].grad.numpy()[:, rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fg["db2"], tw[3].grad.numpy(), rtol=1e-5, atol=1e-6)


def test_sequence_parallel_encode_matches_single_device_jax(world2):
    payload, (params, cfg), ranks = world2
    mel = payload["sp"][2]
    base = np.asarray(jax_encode_audio(as_jax(params), cfg, jnp.asarray(mel)))
    for out in ranks:
        np.testing.assert_allclose(out["sp"], base, atol=2e-4, rtol=1e-4)


def test_sequence_parallel_refusals(world2):
    _, _, ranks = world2
    t_msg, h_msg = ranks[0]["sp_refusals"]
    assert "frames (1499)" in t_msg and "divisible" in t_msg
    assert "heads (3)" in h_msg and "divisible" in h_msg
    assert "inference path" in ranks[0]["sp_grad_refusal"]


def test_rank_coordinates(world2, tmp_path):
    """Rank r sits at (r // model, r % model), as JAX's devices.reshape
    (data, model): on (1 x 2), on (2 x 1) and on (2 x 2), with each data
    rank's rows of a batch of 8."""
    _, _, ranks = world2
    assert [out["coords"] for out in ranks] == [[(0, 0), (0, 0)], [(0, 1), (1, 0)]]
    got = tph.run_ranks(tph.coordinates, 4, tmp_path)
    for r, (coord, d, m, nd, nm, rows) in enumerate(got):
        assert coord == (r // 2, r % 2) == (d, m) and (nd, nm) == (2, 2)
        assert rows == slice(4 * d, 4 * d + 4)
