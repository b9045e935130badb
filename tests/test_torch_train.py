"""The port's training path against the JAX package on the CPU, float32, at
tiny configs (as tests/test_torch_model.py): the teacher-forced loss and
logits, the training forward's loss and every parameter gradient on a long
row (the flash branch), dropout under remat, the optimizer and the Trainer
step for step, schedules and losses, checkpoints, resume, `train_main`, and
an overfit run whose greedy decode (int8 KV, int8 weights) reproduces the
samples."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.linen import meta

from markushgrapher_tpu.config import (MarkushGrapherConfig, SwinConfig,
                                       TrainConfig, VTLConfig)
from markushgrapher_tpu.models import markushgrapher as jmg
from markushgrapher_tpu.parallel import mesh as mesh_lib
from markushgrapher_tpu.train import losses as jlosses
from markushgrapher_tpu.train import optim as joptim
from markushgrapher_tpu.train import tf_metrics as jtf
from markushgrapher_tpu.train.trainer import Trainer as JTrainer
from markushgrapher_torch.config import TrainConfig as TTrainConfig
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.models import markushgrapher as tmg
from markushgrapher_torch.ops import flash_attention as tfa
from markushgrapher_torch.train import checkpoint as tckpt
from markushgrapher_torch.train import losses as tlosses
from markushgrapher_torch.train import optim as toptim
from markushgrapher_torch.train import tf_metrics as ttf
from markushgrapher_torch.train.trainer import Trainer as TTrainer

S = 8          # decoder positions
# JAX and port relative errors: the forward in float32 differs only in
# summation order (1e-5 of the largest logit / of the loss)
FWD_TOL = 1e-5
# gradients: relative L2 per parameter. On the long row the encoder bias is
# the bf16 training slab on both sides, so each layer's d(bias) is rounded
# to bf16 and the three table gradients sum them: a one-ulp rounding flip
# where the two float32 sums straddle a bf16 tie moves them by ~4e-5
# (with a float32 slab on both sides they agree to ~4e-6)
GRAD_TOL = 1e-4


def tiny_cfg(variant, text_len, dropout=0.0):
    return MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=128, d_model=32, d_kv=4, d_ff=64,
                      num_layers=2, num_decoder_layers=2, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=dropout),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        architecture_variant=variant, max_seq_length=text_len,
        max_seq_length_decoder=S)


def tiny_batch(text_len, seed=0, batch=2, n_valid=(300, 180)):
    rng = np.random.RandomState(seed)
    bbox = np.sort(rng.rand(batch, text_len, 4).astype(np.float32), axis=-1)
    bbox = bbox[..., [0, 2, 1, 3]]          # x0 <= x1, y0 <= y1
    mask = np.zeros((batch, text_len), np.int32)
    for b in range(batch):
        n = min(n_valid[b % len(n_valid)], text_len)
        mask[b, :n] = 1
        bbox[b, n:] = 0.0
    labels = rng.randint(3, 120, size=(batch, S)).astype(np.int32)
    labels[-1, S - 3:] = -100
    return dict(
        input_ids=rng.randint(3, 120, size=(batch, text_len)).astype(
            np.int32),
        bbox=bbox, attention_mask=mask, labels=labels,
        pixel_values=rng.rand(batch, 64, 64, 3).astype(np.float32),
        ocsr_pixel_values=rng.rand(batch, 16, 16, 3).astype(np.float32))


def jax_params(cfg, batch, seed=0):
    model = jmg.MarkushGrapherModel(cfg, dtype=jnp.float32)
    init = {k: jnp.asarray(v) for k, v in batch.items()}
    return model, meta.unbox(model.init(jax.random.PRNGKey(seed), **init))


def torch_model(cfg, params):
    model = tmg.MarkushGrapherModel(cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# -- the teacher-forced forward and the gradients -----------------------------


@pytest.mark.parametrize("variant", ["none", "me-lf-stack-1"])
def test_teacher_forced_loss_and_logits_match_jax(variant):
    """deterministic=True: dense attention with the float32 bias, as the
    reference's teacher-forced eval (496 text + 16 patches)."""
    cfg = tiny_cfg(variant, 496)
    batch = tiny_batch(496)
    jm, params = jax_params(cfg, batch)
    out_j = jm.apply(params, **{k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg, params)
    with torch.no_grad():
        out_t = model(**to_torch(batch))
    assert out_t["logits"].dtype == torch.float32
    assert rel(out_t["logits"].numpy(), out_j["logits"]) < FWD_TOL
    assert rel(float(out_t["loss"]), float(out_j["loss"])) < FWD_TOL


def test_training_gradients_match_jax(monkeypatch):
    """deterministic=False on a long row (752 text + 16 patches = 768): the
    reference's training branch (the materialised bf16 slab,
    MARKUSH_TRAIN_BIAS=onehot_mat; its CPU attention is the chunked scan,
    the same function as the flash kernels) against the port's, which goes
    through FlashAttentionBias. Loss, and every parameter's gradient by the
    weight bridge's names."""
    monkeypatch.setenv("MARKUSH_TRAIN_BIAS", "onehot_mat")
    cfg = tiny_cfg("me-lf-stack-1", 752)
    batch = tiny_batch(752, seed=1)
    jm, params = jax_params(cfg, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jm.apply(p, **jb, deterministic=False)["loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    grads_j = params_from_jax(jax.tree.map(np.asarray, grads_j))

    calls = []
    fwd = tfa.flash_bias_fwd
    monkeypatch.setattr(tfa, "flash_bias_fwd",
                        lambda *a: calls.append(a[3].dtype) or fwd(*a))
    model = torch_model(cfg, params)
    out = model(**to_torch(batch), deterministic=False)
    out["loss"].backward()
    assert calls == [torch.bfloat16] * cfg.vtl.num_layers
    assert rel(float(out["loss"].detach()), float(loss_j)) < FWD_TOL
    names = dict(model.named_parameters())
    assert set(names) == set(grads_j)
    for name, p in names.items():
        assert p.grad is not None, name
        err = rel_l2(p.grad.numpy(), grads_j[name].numpy())
        assert err < GRAD_TOL, (name, err)


def test_dropout_is_seeded_and_remat_replays_it():
    """Dropout 0.1: the same generator seed gives the same loss, another
    seed another; recomputing every layer under checkpoint (remat) draws the
    same masks, so loss and gradients equal the stored-activation run."""
    cfg = tiny_cfg("none", 752, dropout=0.1)
    batch = to_torch(tiny_batch(752, seed=2))
    model = tmg.MarkushGrapherModel(cfg).init_weights(0)

    def run(seed, remat):
        model.remat = remat
        model.zero_grad(set_to_none=True)
        out = model(**batch, deterministic=False,
                    generator=torch.Generator().manual_seed(seed))
        out["loss"].backward()
        return float(out["loss"].detach()), {n: p.grad.clone()
                                    for n, p in model.named_parameters()}

    loss_a, grads_a = run(5, False)
    loss_b, grads_b = run(5, True)
    loss_c, _ = run(6, False)
    assert loss_a == loss_b and loss_a != loss_c
    for name, g in grads_a.items():
        torch.testing.assert_close(grads_b[name], g, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="Generator"):
        model(**batch, deterministic=False)


# -- optimizer, schedules, losses ---------------------------------------------


def test_schedules_match_jax():
    steps = np.arange(0, 3001)
    cases = [
        (joptim.inverse_sqrt_schedule(5e-4, 1000),
         toptim.inverse_sqrt_schedule(5e-4, 1000)),
        (joptim.linear_with_fact_schedule(5e-4, 100, 2000, fact=0.5),
         toptim.linear_with_fact_schedule(5e-4, 100, 2000, fact=0.5)),
    ]
    for kind in ("inverse_sqrt", "linear_with_fact", "constant", "linear"):
        cfg = dict(lr_schedule=kind, learning_rate=3e-4, warmup_steps=50,
                   max_steps=2500)
        cases.append((joptim.make_schedule(TrainConfig(**cfg)),
                      toptim.make_schedule(TTrainConfig(**cfg))))
    for jfn, tfn in cases:
        want = np.array([float(jfn(jnp.int32(s))) for s in steps],
                        np.float32)
        got = np.array([tfn(int(s)) for s in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_huber_losses_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, size=(2, 7)).astype(np.int32)
    labels[1, 4:] = -100
    pred, target = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(
        np.float32)
    np.testing.assert_allclose(
        float(tlosses.huber_loss(torch.from_numpy(pred),
                                 torch.from_numpy(target), 0.7)),
        float(jlosses.huber_loss(pred, target, 0.7)), rtol=1e-6)
    for name in ("CE", "huber", "huber2"):
        want = float(jlosses.get_loss_fn(name)(jnp.asarray(logits),
                                               jnp.asarray(labels)))
        got = float(tlosses.get_loss_fn(name)(torch.from_numpy(logits),
                                              torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    want = float(jmg.cross_entropy_with_ignore(
        jnp.asarray(logits), jnp.asarray(labels), label_smoothing=0.1))
    got = float(tmg.cross_entropy_with_ignore(
        torch.from_numpy(logits), torch.from_numpy(labels),
        label_smoothing=0.1))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_matches_optax_on_the_same_gradients():
    """The optimizer alone, fed the same gradients as the reference's optax
    chain: accumulation 2, an engaged clip, weight decay, a frozen subtree;
    six calls (three updates), float32, 1e-6 relative."""
    cfg = dict(learning_rate=1e-2, lr_schedule="inverse_sqrt",
               warmup_steps=2, gradient_accumulation_steps=2,
               max_grad_norm=0.5, weight_decay=0.01)
    rng = np.random.RandomState(7)
    shapes = {"enc": {"w": (4, 3), "b": (3,)}, "frozen": {"w": (2, 2)}}
    params = {m: {n: rng.randn(*s).astype(np.float32)
                  for n, s in leaves.items()} for m, leaves in shapes.items()}
    mask = joptim.freeze_mask(params, (("frozen",),))
    tx = joptim.make_optimizer(TrainConfig(**cfg), frozen_mask=mask)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {f"{m}.{n}": torch.nn.Parameter(torch.from_numpy(v.copy()))
          for m, leaves in params.items() for n, v in leaves.items()}
    opt = toptim.AdamW(tp.items(), TTrainConfig(**cfg), (("frozen",),))
    for call in range(6):
        grads = {m: {n: rng.randn(*s).astype(np.float32) * (call + 1)
                     for n, s in leaves.items()}
                 for m, leaves in shapes.items()}
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({f"{m}.{n}": torch.from_numpy(v) for m, leaves in
                  grads.items() for n, v in leaves.items()})
        for m, leaves in shapes.items():
            for n in leaves:
                got = tp[f"{m}.{n}"].detach().numpy()
                assert rel(got, jp[m][n]) < 1e-6, (call, m, n)
    assert opt.state["count"] == 3
    assert np.array_equal(tp["frozen.w"].detach().numpy(),
                          params["frozen"]["w"])


def test_trainer_steps_match_jax_trainer():
    """Six train_step calls (three updates: accumulation 2) of the port's
    Trainer against the reference's, from the same float32 weights on the
    same batches: an engaged clip (max_grad_norm 0.05), weight decay and
    frozen_prefixes=("molscribe_encoder",). Per call the loss and the logged
    grad norm (over all gradients, frozen included), then every parameter
    (1e-5 of its largest value); the frozen Swin stays bit-unchanged."""
    cfg = tiny_cfg("me-lf-stack-1", 48)
    tc = dict(learning_rate=1e-3, lr_schedule="inverse_sqrt",
              warmup_steps=2, gradient_accumulation_steps=2,
              max_grad_norm=0.05, weight_decay=0.01, dtype="float32",
              remat=False, adam_eps=1e-6)
    batches = [tiny_batch(48, seed=10 + i, n_valid=(40, 25))
               for i in range(6)]
    jtrainer = JTrainer(model=jmg.MarkushGrapherModel(cfg, dtype=jnp.float32),
                        cfg=TrainConfig(**tc),
                        mesh=mesh_lib.create_mesh(
                            data=1, model=1, devices=jax.devices()[:1]),
                        frozen_prefixes=(("molscribe_encoder",),))
    rng = jax.random.PRNGKey(0)
    jstate = jtrainer.init_state(rng, batches[0])
    init = params_from_jax(jax.tree.map(np.asarray,
                                        meta.unbox(jstate.params)))
    ttrainer = TTrainer(model=tmg.MarkushGrapherModel(cfg),
                        cfg=TTrainConfig(**tc),
                        frozen_prefixes=(("molscribe_encoder",),))
    tstate = ttrainer.init_state(params=init)
    for batch in batches:
        jstate, jm = jtrainer.train_step(jstate, batch, rng)
        tstate, tm = ttrainer.train_step(tstate, batch)
        assert rel(float(tm["loss"]), float(jm["loss"])) < FWD_TOL
        assert rel(float(tm["grad_norm"]), float(jm["grad_norm"])) < 1e-5
    assert tstate.step == int(jstate.step) == 6
    final = params_from_jax(jax.tree.map(np.asarray,
                                         meta.unbox(jstate.params)))
    for name, p in tstate.params.named_parameters():
        got = p.detach().numpy()
        if name.startswith("molscribe_encoder."):
            assert np.array_equal(got, init[name].numpy()), name
        else:
            assert rel(got, final[name].numpy()) < 1e-5, name


def test_token_metrics_match_jax():
    rng = np.random.RandomState(9)
    from markushgrapher_torch.data.vocab import LOC_BASE_ID

    labels = rng.randint(LOC_BASE_ID - 5, LOC_BASE_ID + 20,
                         size=(2, 12)).astype(np.int32)
    labels[0, 8:] = -100
    logits = rng.randn(2, 12, LOC_BASE_ID + 30).astype(np.float32)
    want = jtf.token_metrics(jnp.asarray(logits), jnp.asarray(labels))
    got = ttf.token_metrics(torch.from_numpy(logits), torch.from_numpy(labels))
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-6)
    preds = logits.argmax(-1)
    assert ttf.loc_box_iou(preds, labels) == jtf.loc_box_iou(preds, labels)


def test_teacher_forced_eval_matches_jax():
    cfg = tiny_cfg("none", 48)
    batch = tiny_batch(48, seed=3, n_valid=(40, 25))
    jm, params = jax_params(cfg, batch)
    want = jtf.teacher_forced_eval(
        jm, params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ttf.teacher_forced_eval(torch_model(cfg, params), to_torch(batch))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


def test_curriculum_callback_matches_jax():
    from markushgrapher_tpu.train.trainer import CurriculumCallback as JCur
    from markushgrapher_torch.train.trainer import CurriculumCallback as TCur

    kw = dict(curriculum=True, curriculum_patience=2,
              curriculum_threshold=0.01)
    j, t = JCur(TrainConfig(**kw)), TCur(TTrainConfig(**kw))
    for loss in (1.0, 0.9, 0.895, 0.9, 0.5, 0.6, 0.7, None, 0.4, 0.45, 0.5):
        assert t.update(loss) == j.update(loss)
    assert t.level == j.level >= 1


# -- checkpoints, resume, train_main -------------------------------------------


def small_trainer(tmp_path, **over):
    cfg = tiny_cfg("none", 48)
    tc = TTrainConfig(**dict(dict(learning_rate=1e-3, warmup_steps=1,
                                  gradient_accumulation_steps=2,
                                  dtype="float32", save_steps=2,
                                  save_total_limit=2, max_steps=6), **over))
    trainer = TTrainer(model=tmg.MarkushGrapherModel(cfg), cfg=tc)
    return trainer, trainer.init_state(seed=0)


def batches(n, seed=0):
    return [tiny_batch(48, seed=seed + i, n_valid=(40, 25)) for i in range(n)]


def test_checkpoint_roundtrip_rotation_and_best_marker(tmp_path):
    trainer, state = small_trainer(tmp_path)
    ckptr = tckpt.Checkpointer(str(tmp_path / "out"), save_total_limit=2)
    trainer.metric_for_best_model = "score"
    evals = iter([0.5, 0.4, 0.9])
    trainer.eval_fn = lambda st, step: {"score": next(evals)}
    trainer.cfg = dataclasses.replace(trainer.cfg, eval_steps=2)
    state = trainer.train(state, iter(batches(6)), max_steps=6,
                          checkpointer=ckptr)
    names = sorted(os.listdir(ckptr.output_dir))
    # rotation keeps the newest two step checkpoints
    assert [n for n in names if n.startswith("checkpoint-")] == [
        "checkpoint-4", "checkpoint-6"]
    marker = (tmp_path / "out" / "best_checkpoint.txt").read_text()
    assert marker.splitlines() == [
        os.path.join(ckptr.output_dir, "checkpoint-6"), "score=0.9"]
    assert trainer.best_step == 6
    assert tckpt.last_checkpoint(ckptr.output_dir).endswith("checkpoint-6")

    want_params = {k: v.clone() for k, v in state.params.state_dict().items()}
    want_mu = {k: v.clone() for k, v in state.opt.state["mu"].items()}
    want_count = state.opt.state["count"]
    _, other = small_trainer(tmp_path)          # fresh weights and moments
    other = ckptr.restore(ckptr.output_dir + "/checkpoint-6", other)
    assert other.step == 6 and other.opt.state["count"] == want_count == 3
    for k, v in other.params.state_dict().items():
        assert torch.equal(v, want_params[k]), k
    for k, v in other.opt.state["mu"].items():
        assert torch.equal(v, want_mu[k]), k
    params = ckptr.restore_params(ckptr.output_dir + "/checkpoint-6")
    assert all(torch.equal(params[k], v) for k, v in want_params.items())


def test_resumed_train_stops_at_max_steps(tmp_path):
    trainer, state = small_trainer(tmp_path)
    ckptr = tckpt.Checkpointer(str(tmp_path / "out"), save_total_limit=5)
    state = trainer.train(state, iter(batches(4)), max_steps=4,
                          checkpointer=ckptr)
    assert state.step == 4
    trainer2, resumed = small_trainer(tmp_path)
    resumed = ckptr.restore(tckpt.last_checkpoint(ckptr.output_dir), resumed)
    assert resumed.step == 4
    seen = []
    data = (seen.append(i) or b for i, b in enumerate(batches(10, seed=50)))
    resumed = trainer2.train(resumed, data, max_steps=6, checkpointer=ckptr)
    # two more steps (4 -> 6), then one batch is drawn and not trained on
    assert resumed.step == 6 and len(seen) == 3
    assert tckpt.last_checkpoint(ckptr.output_dir).endswith("checkpoint-6")


def test_weight_export_and_fingerprints(tmp_path):
    trainer, state = small_trainer(tmp_path)
    params = state.params.state_dict()
    written = tckpt.save_weights_separately(params, str(tmp_path / "w"))
    assert sorted(os.path.basename(p) for p in written) == [
        "decoder.pt", "encoder.pt", "lm_head.pt", "shared_embedding.pt"]
    stats = tckpt.compute_weight_stats(params)
    assert stats["num_params"] == sum(p.numel() for p in params.values())
    ref = tmp_path / "stats.json"
    ref.write_text(json.dumps(stats))
    assert tckpt.compare_module_weights(params, str(ref)) == []
    changed = dict(params)
    changed["decoder.layer_0.ff.wo.weight"] = params[
        "decoder.layer_0.ff.wo.weight"] + 1.0
    assert any("decoder.layer_0.ff.wo.weight" in p for p in
               tckpt.compare_module_weights(changed, str(ref)))
    restored = tckpt.load_submodule_weights(
        changed, "decoder", str(tmp_path / "w" / "decoder.pt"))
    assert torch.equal(restored["decoder.layer_0.ff.wo.weight"],
                       params["decoder.layer_0.ff.wo.weight"])
    with pytest.raises(KeyError):
        tckpt.load_submodule_weights(changed, "molscribe_encoder",
                                     str(tmp_path / "w" / "decoder.pt"))


def _tiny_train_yaml(tmp_path):
    """(YAML path, output_dir) of train_main on a tiny synthetic dataset
    saved to disk (as tests/test_pipeline.py builds one): 2 steps."""
    import datasets as hfds
    import yaml

    annot = ("<markush><cxsmi>CC(<r>R1</r>)c1ccc(O)cc1</cxsmi>"
             "<stable>R1:F<n>Cl</stable></markush>")

    def split(n):
        return hfds.Dataset.from_list([
            dict(id=i, page_image=np.full((64, 64, 3), 255,
                                          np.uint8).tolist(),
                 cells=[{"text": "R1 = F or Cl",
                         "bbox": [0.1, 0.8, 0.5, 0.9]}],
                 annotation=annot, cxsmiles_opt="CC(<r>R1</r>)c1ccc(O)cc1")
            for i in range(n)])

    ds_path = str(tmp_path / "mdu_tiny")
    hfds.DatasetDict(train=split(8), val=split(2), test=split(2)
                     ).save_to_disk(ds_path)
    datasets_yaml = tmp_path / "datasets.yaml"
    yaml.safe_dump({"mdu_tiny": {"dataset_path": ds_path,
                                 "encode_position": False,
                                 "encode_index": False,
                                 "condense_labels": True,
                                 "normalize_bbox": True}},
                   datasets_yaml.open("w"))
    out = tmp_path / "out"
    cfg = dict(datasets_config=str(datasets_yaml), dataset_name="mdu_tiny",
               image_size=32, max_seq_length=64, max_seq_length_decoder=48,
               vocab_size=33201, d_model=32, num_layers=1, num_heads=2,
               d_ff=64, output_dir=str(out), per_device_train_batch_size=1,
               per_device_eval_batch_size=2, gradient_accumulation_steps=1,
               max_steps=2, warmup_steps=1, eval_steps=100, save_steps=100,
               logging_steps=1, bf16=False, augment_train=False,
               architecture_variant="none", freeze_molscribe_encoder=False)
    path = tmp_path / "train.yaml"
    yaml.safe_dump(cfg, path.open("w"))
    return path, out


def test_train_main_on_cpu_writes_checkpoint(tmp_path):
    """train_main on a tiny synthetic dataset, device="cpu": 2 steps, then
    checkpoint-2 and the result files."""
    from markushgrapher_torch import train_main

    path, out = _tiny_train_yaml(tmp_path)
    last = train_main.main(str(path), device="cpu")
    assert last["step"] == 2 and np.isfinite(last["loss"])
    assert os.path.isfile(out / "checkpoint-2" / "state")
    assert json.loads((out / "train_results.json").read_text())[-1][
        "step"] == 2
    assert (out / "metrics.jsonl").read_text().count("\n") == 2


def test_eval_main_scores_the_train_main_checkpoint(tmp_path, monkeypatch):
    """train_main for 2 steps, then eval_main on the same YAML and
    output_dir (no model_name_or_path): as the reference's, it restores the
    last checkpoint there, so the model it scores holds the checkpoint's
    tensors (cast to the evaluator's bf16), not the random init."""
    from markushgrapher_torch import eval_main, train_main
    from markushgrapher_torch.train.checkpoint import Checkpointer

    path, out = _tiny_train_yaml(tmp_path)
    train_main.main(str(path), device="cpu")
    scored = []

    class Capture(eval_main.Evaluator):
        def __init__(self, model, *args, **kw):
            super().__init__(model, *args, **kw)
            scored.append(self.model)

    monkeypatch.setattr(eval_main, "Evaluator", Capture)
    scores = eval_main.main(str(path), device="cpu")
    assert scores and len(scored) == 1
    saved = Checkpointer(str(out)).restore_params(str(out / "checkpoint-2"))
    got = scored[0].state_dict()
    assert set(got) == set(saved)
    for name, t in saved.items():
        assert torch.equal(got[name], t.to(got[name].dtype)), name
    fresh = tmg.MarkushGrapherModel(scored[0].cfg).init_weights(seed=0)
    assert not torch.equal(fresh.state_dict()["lm_head.weight"].to(
        torch.bfloat16), got["lm_head.weight"])


# -- learning end to end --------------------------------------------------------


# the thread count of the overfit run (with deterministic algorithms, the
# run is then the same in every process)
OVERFIT_THREADS = 4


@pytest.fixture(scope="module")
def overfit():
    """tests/test_learning.py::TestEndToEndLearning through the port: the
    same tiny config, corpus (2 unique synthetic samples, duplicated to a
    batch of 4) and initial weights (the JAX model's init at PRNGKey(0),
    through the weight bridge), trained by the port's Trainer in float32
    until the loss is below 1e-3 (800-step cap). The rate decays linearly
    to 0 over the cap: at the reference test's constant 5e-3 Adam is
    chaotic here. The run is made deterministic while it trains: a fixed
    thread count and `torch.use_deterministic_algorithms`, both restored
    afterwards. Without them two runs at one thread count part after a few
    steps: the backward of the relative-bias gather (`table[buckets]`, an
    accumulating `index_put_` of 50k entries into a 32-row table) adds in
    an order that changes from run to run, and some runs did not settle
    within 800 steps (final loss 0.059)."""
    from markushgrapher_torch.data.collator import DataCollator
    from markushgrapher_torch.data.dataset import MDUDataset
    from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
    from markushgrapher_torch.data.synthetic import SyntheticMarkushGenerator

    gen = SyntheticMarkushGenerator(seed=3, image_size=64, max_rgroups=1,
                                    p_m_section=0.0, p_sg_section=0.0)
    samples = [gen.sample(i) for i in range(2)] * 2
    mt = MarkushTokenizer()
    ds = MDUDataset(source=samples, markush_tokenizer=mt, image_size=64,
                    ocsr_image_size=32, max_seq_length=96,
                    max_seq_length_decoder=64)
    batch = DataCollator(max_length=96, max_length_decoder=64)(
        [ds[i] for i in range(4)])
    batch = {k: v for k, v in batch.items() if k != "id"}
    assert batch["labels"].max() < 8192
    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=8192, d_model=64, d_kv=16, d_ff=128,
                      num_layers=2, num_decoder_layers=2, num_heads=4,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=32, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        architecture_variant="none", max_seq_length=96,
        max_seq_length_decoder=64)
    trainer = TTrainer(
        model=tmg.MarkushGrapherModel(cfg, bias_int8=True),
        cfg=TTrainConfig(learning_rate=5e-3, warmup_steps=20,
                         lr_schedule="linear", max_steps=800,
                         gradient_accumulation_steps=1, max_grad_norm=1.0,
                         dtype="float32", remat=False))
    _, init = jax_params(cfg, batch)
    threads = torch.get_num_threads()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(OVERFIT_THREADS)
    torch.use_deterministic_algorithms(True)
    try:
        state = trainer.init_state(
            params=params_from_jax(jax.tree.map(np.asarray, init)))
        loss = None
        for _ in range(800):
            state, m = trainer.train_step(state, batch)
            loss = float(m["loss"])
            if loss < 1e-3:
                break
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(deterministic)
    inputs = {k: torch.as_tensor(batch[k]) for k in
              ("input_ids", "bbox", "attention_mask", "pixel_values")}
    return dict(model=state.params.eval(), loss=loss, inputs=inputs,
                samples=samples[:2], mt=mt)


# generate's decode-weight flags of each weight scheme
WEIGHTS = {"float": {}, "int8": dict(quant_weights=True),
           "int4": dict(quant_weights=True, weight_bits=4),
           "w8a8": dict(quant_weights=True, act_quant=True)}


def _exact_matches(overfit, kv: str, weights: str, pack: bool = False) -> int:
    """Greedy decode of the overfit model under a KV scheme ("float",
    "int8", "int4") and decode weights ("float", "int8", "int4", "w8a8"),
    with the cross caches packed to the batch's valid maximum when `pack`:
    how many of the two samples come out CXSMILES-equal."""
    from markushgrapher_torch.chem.evaluation import score_sample
    from markushgrapher_torch.decode.generate import generate

    mt = overfit["mt"]
    model = overfit["model"].clone(int4_cross=kv == "int4")
    inputs = overfit["inputs"]
    cross_pack_len = None
    if pack:
        _, enc_mask = model.encode(inputs["input_ids"], inputs["bbox"],
                                   inputs["attention_mask"],
                                   inputs["pixel_values"], None)
        cross_pack_len = int(enc_mask.sum(1).max())
    out = generate(model, inputs, max_length=64, eos_id=1,
                   quant_cross_kv=kv != "float",
                   cross_pack_len=cross_pack_len, **WEIGHTS[weights]).numpy()
    exact = 0
    for i, sample in enumerate(overfit["samples"]):
        gt_stable = mt.get_stable(sample["annotation"]) or {}
        exact += bool(score_sample(mt.decode(out[i]), sample["cxsmiles_opt"],
                                   gt_stable, mt)["markush_equality"])
    return exact


def test_overfit_then_greedy_int8_reproduces_samples(overfit):
    """The overfit run (fixture) reaches a loss below 0.05 within its
    800-step cap; greedy decode under the serving scheme (int8 KV, int8
    weights) then reproduces both samples exactly (CXSMILES equality)."""
    assert overfit["loss"] < 0.05, \
        f"did not overfit: final loss {overfit['loss']}"
    assert _exact_matches(overfit, "int8", "int8") == 2


@pytest.mark.parametrize("kv,weights", [("float", "float"),
                                        ("int8", "float"),
                                        ("int4", "int8"),
                                        ("int4", "int4"),
                                        ("int4", "w8a8")])
def test_overfit_quantisation_gate(overfit, kv, weights):
    """tests/test_learning.py::TestQuantizationGate through the port: the
    float32 decode (float KV, float weights) reproduces both samples, and
    every quantised serving mode (int8 KV with float or int8 weights, the
    latter in the test above; int4 KV with int8 weights, int4 weights or
    W8A8 dots) keeps at least its exact matches."""
    baseline = _exact_matches(overfit, "float", "float")
    assert baseline == 2
    assert _exact_matches(overfit, kv, weights) >= baseline


def test_overfit_full_decode_stack_gate(overfit):
    """TestQuantizationGate.test_full_decode_stack through the port: int4
    KV, W8A8 dots and the cross caches packed to the batch's valid maximum
    keep the float32 decode's exact matches."""
    baseline = _exact_matches(overfit, "float", "float")
    assert baseline == 2
    assert _exact_matches(overfit, "int4", "w8a8", pack=True) >= baseline
