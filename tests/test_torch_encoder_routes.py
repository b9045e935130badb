"""The port's four serving encoder routes against the JAX package on the CPU
(Pallas in interpret mode on the JAX side), on seeded numpy inputs: the
in-kernel relative-bias flash attention (`ops.flash_relbias`), the bf16
slab builder (`relbias.encoder_position_bias_chunked`), `encode` under each
route at f32 on a tiny config, and greedy tokens from the packed encoder."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.decode import generate as jgen
from markushgrapher_tpu.models import markushgrapher as jmg
from markushgrapher_tpu.ops import flash_relbias as j_relbias_flash
from markushgrapher_tpu.ops import relbias as j_relbias
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.decode import generate as tgen
from markushgrapher_torch.models import markushgrapher as tmg
from markushgrapher_torch.ops import flash_relbias, relbias
from test_torch_model import tiny_batch, tiny_cfg

NB, MAX1, MAX2, SCALE = 32, 128, 100, 100


def relbias_inputs(B, L, H, D, seed=0):
    """The inputs of tests/test_flash_relbias.py: q, k, v, bbox centres, a
    mask with the last 16 keys padded, and the three tables."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    bbox = rng.rand(B, L, 4).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[:, -16:] = 0
    tables = [rng.randn(NB, H).astype(np.float32) for _ in range(3)]
    hx = (bbox[..., 0] + bbox[..., 2]) / 2.0
    vy = (bbox[..., 1] + bbox[..., 3]) / 2.0
    return q, k, v, hx, vy, mask, tables, bbox


@pytest.mark.parametrize("B,L,H,D,bq,bk", [
    (2, 256, 2, 64, 128, 128),
    (1, 512, 4, 64, 256, 512),
])
def test_flash_relbias_plain_matches_jax(B, L, H, D, bq, bk):
    """plain vs the JAX kernel in interpret mode: both float32, online
    against dense softmax, so only summation order differs (the tolerance
    of tests/test_flash_relbias.py)."""
    q, k, v, hx, vy, mask, tables, _ = relbias_inputs(B, L, H, D)
    want = j_relbias_flash.flash_attention_relbias(
        *(jnp.asarray(a) for a in (q, k, v, hx, vy, mask, *tables)),
        block_q=bq, block_k=bk)
    got = flash_relbias.flash_attention_relbias(
        *(torch.from_numpy(a) for a in (q, k, v, hx, vy, mask, *tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_chunked_slab_matches_jax(packed, out_dtype):
    """The bf16 serving slab (and its float32 form) equals JAX's chunked
    builder on unmasked entries; masked entries are <= -1e8 on both sides.
    With `positions` (a packed encoder's original indices, here a sorted
    random subset of 3L positions per row) the 1d buckets follow them."""
    rng = np.random.RandomState(1)
    B, L, H = 2, 256, 4
    bbox = rng.rand(B, L, 4).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[:, -10:] = 0
    tables = [rng.randn(NB, H).astype(np.float32) for _ in range(3)]
    pos = (np.stack([np.sort(rng.permutation(3 * L)[:L]) for _ in range(B)])
           .astype(np.int32) if packed else None)
    args = (L, NB, MAX1, SCALE, MAX2)
    want = np.asarray(j_relbias.encoder_position_bias_chunked(
        *(jnp.asarray(t) for t in tables), jnp.asarray(bbox),
        jnp.asarray(mask), *args, chunk=64,
        out_dtype=getattr(jnp, out_dtype),
        positions=None if pos is None else jnp.asarray(pos)
    ).astype(jnp.float32))
    got = relbias.encoder_position_bias_chunked(
        *(torch.from_numpy(t) for t in tables), torch.from_numpy(bbox),
        torch.from_numpy(mask), *args, chunk=64,
        out_dtype=getattr(torch, out_dtype),
        positions=None if pos is None else torch.from_numpy(pos))
    assert got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy()
    keep = np.broadcast_to(mask[:, None, None, :].astype(bool), got.shape)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-5, rtol=0)
    assert (got[~keep] <= -1e8).all() and (want[~keep] <= -1e8).all()


# -- encode under each route ------------------------------------------------

PACK = 256
# route -> model flags (the JAX model also gets flash_attention=True)
ROUTES = {
    "int8_slab": dict(bias_int8=True),
    "bf16_slab": dict(),
    "inkernel": dict(inkernel_bias=True),
    "packed_int8": dict(bias_int8=True, encoder_pack_len=PACK),
    "packed_bf16": dict(encoder_pack_len=PACK),
}


@pytest.fixture(scope="module")
def routes_setup():
    """Tiny config (496 text + 16 patches = 512, where the JAX flash routes
    and its in-kernel bias engage), a batch whose rows keep at most 236 of
    the 512 positions valid (so a 256 pack holds them), and the same weights
    on both sides."""
    cfg = tiny_cfg("none")
    batch = tiny_batch(3)
    batch["attention_mask"][:, 220:] = 0
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    init_batch["labels"] = jnp.zeros((2, cfg.max_seq_length_decoder),
                                     jnp.int32)
    params = meta.unbox(jmg.MarkushGrapherModel(
        cfg, dtype=jnp.float32).init(jax.random.PRNGKey(3), **init_batch))
    tree = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, batch, params, tree


def _jax_encode(cfg, params, batch, **flags):
    model = jmg.MarkushGrapherModel(cfg, dtype=jnp.float32,
                                    flash_attention=True, **flags)
    args = [jnp.asarray(batch[k]) for k in
            ("input_ids", "bbox", "attention_mask", "pixel_values",
             "ocsr_pixel_values")]
    enc, mask = model.apply(params, *args,
                            method=jmg.MarkushGrapherModel.encode)
    return model, enc, mask


def _torch_model(cfg, tree, **flags):
    model = tmg.MarkushGrapherModel(cfg, **flags)
    model.load_state_dict(tree)
    return model


def _torch_encode(model, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model.encode(t["input_ids"], t["bbox"], t["attention_mask"],
                        t["pixel_values"], t["ocsr_pixel_values"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_route_matches_jax(routes_setup, route):
    """Encoder states at the valid positions equal the JAX model's at f32
    under the same route: the same slab (int8: bit-exact builders; bf16:
    the same float32 sums rounded once) or the same in-kernel bias, so only
    float order differs: within 1e-4 of the largest state."""
    cfg, batch, params, tree = routes_setup
    _, enc_j, mask_j = _jax_encode(cfg, params, batch, **ROUTES[route])
    enc_t, mask_t = _torch_encode(_torch_model(cfg, tree, **ROUTES[route]),
                                  batch)
    mask_j = np.asarray(mask_j)
    assert enc_t.shape == enc_j.shape
    assert enc_t.shape[1] == (PACK if "packed" in route else 512)
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)
    valid = mask_j > 0
    ref = np.asarray(enc_j)[valid]
    err = np.abs(enc_t.numpy()[valid] - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


def test_encode_routes_take_their_kernels(routes_setup, monkeypatch):
    """Each route's attention goes through its own kernel wrapper in every
    layer (the plain versions run on CPU tensors): no route quietly takes
    another's."""
    from markushgrapher_torch.ops import bias_build, flash_attention

    cfg, batch, _, tree = routes_setup
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, call)

    spy(bias_build, "encoder_position_bias_kernel_i8")
    spy(flash_attention, "flash_attention_bias_i8")
    spy(flash_attention, "flash_attention_bias")
    spy(flash_relbias, "flash_attention_relbias")
    layers = cfg.vtl.num_layers
    want = {"int8_slab": {"encoder_position_bias_kernel_i8": 1,
                          "flash_attention_bias_i8": layers},
            "bf16_slab": {"flash_attention_bias": layers},
            "inkernel": {"flash_attention_relbias": layers},
            # a packed encoder builds a slab: the in-kernel bias knows no
            # positions, as in the reference
            "packed_inkernel": {"flash_attention_bias": layers}}
    flags = dict(ROUTES, packed_inkernel=dict(inkernel_bias=True,
                                              encoder_pack_len=PACK))
    for route, counts in want.items():
        calls.clear()
        _torch_encode(_torch_model(cfg, tree, **flags[route]), batch)
        assert calls == counts, route


@pytest.mark.parametrize("route", list(tmg.ROUTES))
def test_clone_takes_a_route_over_the_same_weights(routes_setup, route):
    """`route_flags` + `clone` give a model on a named route that encodes
    exactly as one built with those constructor flags, over the base
    model's own parameters; the base keeps its flags. The packed route packs
    to the ceil-256 of the batch's VTL valid count (236 here: 256)."""
    cfg, batch, _, tree = routes_setup
    base = _torch_model(cfg, tree)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    flags = tmg.route_flags(cfg, route, t["bbox"], t["attention_mask"])
    if route == "packed":
        assert flags["encoder_pack_len"] == PACK
    routed = base.clone(**flags)
    assert routed.shared_embedding is base.shared_embedding
    assert all(getattr(routed, k) == v for k, v in flags.items())
    assert (base.bias_int8, base.inkernel_bias, base.encoder_pack_len) == (
        False, False, 0)
    want = _torch_encode(_torch_model(cfg, tree, **flags), batch)
    got = _torch_encode(routed, batch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError, match="not a constructor flag"):
        base.clone(flash_attention=True)


@pytest.mark.parametrize("builder", ["encoder_position_bias_chunked",
                                     "encoder_position_bias_chunked_i8"])
def test_slab_builders_need_the_combined_table(builder):
    """Both serving slab builders index the combined table and refuse a
    bucket count whose table would exceed 65536 entries per head."""
    nb, L, H = 48, 8, 2
    tables = [torch.zeros(nb, H) for _ in range(3)]
    with pytest.raises(ValueError, match="combined table"):
        getattr(relbias, builder)(*tables, torch.rand(1, L, 4),
                                  torch.ones(1, L, dtype=torch.int32), L, nb,
                                  MAX1, SCALE, MAX2)


@pytest.mark.parametrize("quant", [False, True])
def test_packed_greedy_equals_unpacked(routes_setup, quant):
    """Greedy tokens decoded from the packed encoder equal those from the
    unpacked one (tests/test_encoder_pack.py's contract), under float caches
    and weights and under int4 KV with int8 weights."""
    cfg, batch, _, tree = routes_setup
    kw = dict(eos_id=1, quant_cross_kv=quant, quant_weights=quant)
    out = []
    for flags in (ROUTES["int8_slab"], ROUTES["packed_int8"]):
        model = _torch_model(cfg, tree, **flags)
        enc, mask = _torch_encode(model, batch)
        out.append(tgen.greedy_generate(model, enc, mask,
                                        cfg.max_seq_length_decoder, **kw))
    assert torch.equal(out[0], out[1])


def test_packed_greedy_matches_jax(routes_setup):
    """The packed bf16-slab route end to end at f32 (float caches and
    weights): greedy tokens equal the JAX model's."""
    cfg, batch, params, tree = routes_setup
    flags = ROUTES["packed_bf16"]
    jmodel, enc_j, mask_j = _jax_encode(cfg, params, batch, **flags)
    ids_j = jgen.greedy_generate(jmodel, params, enc_j, mask_j,
                                 cfg.max_seq_length_decoder, eos_id=1)
    model = _torch_model(cfg, tree, **flags)
    enc_t, mask_t = _torch_encode(model, batch)
    ids_t = tgen.greedy_generate(model, enc_t, mask_t,
                                 cfg.max_seq_length_decoder, eos_id=1)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
