"""The port's sharded train step (slice 6b) on the CPU, each rank a gloo
process (`parallel.distributed.run_ranks`), against the JAX package's
`make_sharded_train_step` on the same mesh (its 8 virtual CPU devices) and its
one-device `make_train_step`, at the tiny VLM of the JAX package's
tests/test_sequence_parallel.py (fp32, plain attention on both sides).

* Full-parameter training against JAX's sharded step at {"dp": 2, "tp": 2}
  tp, {"sp": 2, "tp": 2}, {"dp": 2, "fsdp": 2} zero2, {"fsdp": 2, "tp": 2}
  fsdp+tp and {"dp": 4}; beside them zero2+tp on {"fsdp": 2, "tp": 2}, and
  {"dp": 2, "tp": 2} with a trainable mask (the towers frozen, a layer mask
  over the trunk) against the port's masked one-process step. The batch's
  dp shards hold unequal counts of valid labels (5 and 14), where a mean of
  per-rank means is not the global mean.
* QLoRA over an int8 trunk and lm_head (the JAX package's default route:
  ``_w8a8_dot`` and its STE; the port's w8a8 route, the row-parallel
  products through `_RowExactSTE`) at {"dp": 2, "tp": 2}, rank 64, so that
  the rules split the factors: B on O over column-parallel bases, A on I
  over row-parallel ones, the fused qkv's B by parts over a base tp leaves
  whole.
* Three zero2 steps on {"fsdp": 2} equal one process step for step (the
  shape of scripts/dryrun_multihost.py without its checkpoint and RLDS
  legs).
* What the step refuses raises, naming it.

Tolerances: the loss within 2e-4 relative and the grad norm within 2e-3
(JAX's own, tests/test_sequence_parallel.py:77-79); action accuracy equal,
L1 within 1e-5; every updated leaf of every rank within 2 lr of the JAX
sharded step's slice and 99 % of its elements within 1e-2 lr (Adam's first
step moves an element by about lr · sign(g) and magnifies a small
gradient's relative difference: every element within 5e-2 lr and 99 % of
each leaf within 1e-3 lr (found at most 1.9e-2 lr and 7e-5 lr), and the same
against the port's one-process step (found 1.7e-2 lr and 1.6e-4 lr). The
QLoRA adapters: each STE backward rounds its cotangent to bf16, so
tests/test_torch_training_steps.py's rule, every element within 2 lr and
99 % within 1e-2 lr (found 1.2 lr and 3.7e-3 lr). Since a first step's
update sees little more than each element's sign, every leaf's gradient is
held too, through its first Adam moment (mu = (1 - b1) · the clipped
gradient) on every rank: within 1e-4 of the reference's in norm, relative to
its norm, in full-parameter training (found at most 1.0e-6 against each of
JAX's sharded step, JAX's one-device step and the port's one process), and
within 5e-3 for the QLoRA adapters (check_tiny_train's per-leaf rule in
chip_smoke.py; found 5.6e-4). A doubled or missing SUM over a data axis, or a
wrong 1 / rep, moves a leaf's moment by a factor, far past either.
The rank workers live at module level and the module imports no JAX at its
top, so a spawned rank imports it cheaply.
"""

import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp
from openvla_probe_tpu_torch.training import lora as tlora
from openvla_probe_tpu_torch.training import train_state as tstate
from openvla_probe_tpu_torch.training import train_step as tstep
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec as TCodec

MESHES = [({"dp": 2, "tp": 2}, "tp", False), ({"sp": 2, "tp": 2}, "tp", False),
          ({"dp": 2, "fsdp": 2}, "zero2", False), ({"fsdp": 2, "tp": 2}, "fsdp+tp", False),
          ({"dp": 4}, "tp", False),
          # beyond JAX's sharded step (its compiles set the file's time): against JAX's
          # one-device step and the port's one process
          ({"fsdp": 2, "tp": 2}, "zero2+tp", False), ({"dp": 2, "tp": 2}, "tp", True)]
JAX_SHARDED = 5   # the first five meshes also against JAX's make_sharded_train_step
QLORA_MESH, QLORA_R = {"dp": 2, "tp": 2}, 64
LR = 1e-3
LOSS_REL, GN_REL = 2e-4, 2e-3
LEAF_MAX, LEAF_P99 = 5e-2 * LR, 1e-3 * LR
QLORA_MAX, QLORA_P99 = 2 * LR, 1e-2 * LR   # tests/test_torch_training_steps.py's rule
MU_REL, QLORA_MU_REL = 1e-4, 5e-3   # each leaf's moment in norm (the module docstring)
RANK_TIMEOUT = 240.0


def opt_kw():
    return dict(learning_rate=LR, lr_schedule_type="constant", max_steps=10, weight_decay=0.01)


def np_batch(vocab: int, image: int, B: int = 4, T: int = 24, seed: int = 0) -> dict:
    """tests/test_sequence_parallel.py's batch, the first dp shard's rows
    holding 5 valid labels against the second's 14 (the next-token shift
    drops none: the labels end before the last position)."""
    rng = np.random.default_rng(seed)
    b = {"input_ids": rng.integers(2, vocab, (B, T)).astype(np.int32),
         "attention_mask": np.ones((B, T), np.int32),
         "pixel_values": rng.normal(size=(B, 6, image, image)).astype(np.float32),
         "labels": np.full((B, T), -100, np.int32)}
    b["labels"][:, -8:-1] = rng.integers(vocab - 256, vocab, (B, 7))
    b["labels"][0, -8:-2] = -100
    b["labels"][1, -8:-5] = -100
    return b


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.float32 if k == "pixel_values" else np.int64))
            for k, v in b.items()}


def train_cfg(jcfg):
    """The port's config of a JAX config, trained as the JAX package trains
    with no kernel gate: the plain attention everywhere."""
    cfg = convert.config_from_jax(jcfg)
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, flash_attn=False),
        vision=tuple(dataclasses.replace(v, flash_attn=False) for v in cfg.vision))


def layer_mask(tree, frozen_tower: bool):
    """The trainable mask: the towers frozen, the trunk's stacked leaves
    trained in their last layer only, the rest trained."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if path.startswith("/vision") and frozen_tower:
            return False
        if "/layers/" in path:
            return np.array([0, 0, 0, 1], np.float32)
        return True
    return walk(tree, "")


# --- the port's ranks ------------------------------------------------------------------


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


def _metrics(m) -> dict:
    out = {k: float(m[k]) for k in ("loss", "grad_norm", "action_accuracy", "l1_loss")}
    out["per_example_loss"] = m["per_example"]["loss"].numpy()
    return out


def rank_full(rank, world, params, cfg, batch, cases):
    """Every full-parameter case on this rank: the new local parameters and
    the metrics."""
    codec = TCodec(vocab_size=cfg.llm.vocab_size)
    out = []
    for axes, strategy, masked in cases:
        mesh = tmesh.make_mesh(dict(axes))
        opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), params)
        state = tstate.TrainState.create(params, opt)
        specs = tsharding.shard_train_state(state, mesh, strategy)
        bspecs = tmesh.sequence_sharding(mesh, batch) if "sp" in axes else tmesh.data_sharding(mesh)
        step = tstep.make_sharded_train_step(
            cfg, opt, mesh, specs, bspecs, codec=codec,
            trainable_mask=layer_mask(params, True) if masked else None)
        D.reset_collective_counts()
        new, m = step(tstep.place_train_state(state, mesh, strategy), batch)
        out.append(dict(metrics=_metrics(m), params=_np_tree(tp.local_tree(new.params)),
                        mu=_np_tree(tp.local_tree(new.opt_state.mu)),
                        calls=dict(D.COLLECTIVE_CALLS)))
    return out


def rank_qlora(rank, world, base, lora, cfg, batch, axes, strategy):
    codec = TCodec(vocab_size=cfg.llm.vocab_size)
    mesh = tmesh.make_mesh(dict(axes))
    lcfg = tlora.LoRAConfig(r=QLORA_R)
    loss_fn = tlora.make_lora_loss_fn(functools.partial(tstep.vla_loss_fn, codec=codec),
                                      tsharding.place_params(base, mesh, strategy), lcfg,
                                      stream=True)
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), lora)
    state = tstate.TrainState.create(lora, opt)
    step = tstep.make_sharded_train_step(cfg, opt, mesh, tsharding.shard_train_state(
        state, mesh, strategy), tmesh.data_sharding(mesh), codec=codec, loss_fn=loss_fn)
    new, m = step(tstep.place_train_state(state, mesh, strategy), batch)
    return dict(metrics=_metrics(m), params=_np_tree(tp.local_tree(new.params)),
                mu=_np_tree(tp.local_tree(new.opt_state.mu)))


def rank_trajectory(rank, world, params, cfg, batch, steps):
    codec = TCodec(vocab_size=cfg.llm.vocab_size)
    mesh = tmesh.make_mesh({"fsdp": world})
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), params)
    state = tstate.TrainState.create(params, opt)
    step = tstep.make_sharded_train_step(cfg, opt, mesh,
                                         tsharding.shard_train_state(state, mesh, "zero2"),
                                         tmesh.data_sharding(mesh), codec=codec)
    state = tstep.place_train_state(state, mesh, "zero2")
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append(dict(metrics=_metrics(m), params=_np_tree(tp.local_tree(state.params)),
                        mu=_np_tree(tp.local_tree(state.opt_state.mu))))
    return out


# --- the JAX side ----------------------------------------------------------------------


def jax_cfg():
    from openvla_probe_tpu.models import vlm as jvlm

    return jvlm.VLMConfig.tiny()


def jax_step(params, jcfg, batch, axes=None, strategy="tp", loss_fn=None, mask=None):
    """(new params as numpy, metrics, the first Adam moment as numpy) of one
    JAX step: `make_sharded_train_step` on `axes`, or `make_train_step` on
    one device."""
    import jax
    import jax.numpy as jnp

    from openvla_probe_tpu.parallel.mesh import data_sharding, make_mesh, sequence_sharding
    from openvla_probe_tpu.parallel.sharding import shard_train_state
    from openvla_probe_tpu.training import train_state as jstate
    from openvla_probe_tpu.training import train_step as jstep
    from openvla_probe_tpu.vla.action_tokenizer import ActionCodec

    codec = ActionCodec(vocab_size=jcfg.llm.vocab_size)
    params = jax.tree.map(jnp.array, params)   # a copy: the sharded step donates its state
    opt = jstate.make_optimizer(jstate.OptimizerConfig(**opt_kw()), params)
    state = jstate.TrainState.create(params, opt)
    if axes is None:
        fn = jstep.make_train_step(jcfg, opt, codec=codec, loss_fn=loss_fn, trainable_mask=mask,
                                   donate=False)
        state, m = fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
    else:
        n = int(np.prod(list(axes.values())))
        mesh = make_mesh(dict(axes), jax.devices()[:n])
        shard = shard_train_state(state, mesh, strategy)
        state = jax.device_put(state, shard)
        bs = sequence_sharding(mesh, batch) if "sp" in axes else \
            jax.tree.map(lambda _: data_sharding(mesh), batch)
        fn = jstep.make_sharded_train_step(jcfg, opt, mesh, shard, bs, codec=codec,
                                           trainable_mask=mask, loss_fn=loss_fn)
        state, m = fn(state, jax.device_put(batch, bs))
    met = {k: float(m[k]) for k in ("loss", "grad_norm", "action_accuracy", "l1_loss")}
    met["per_example_loss"] = np.asarray(m["per_example"]["loss"])
    adam = next(s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                     is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    return jax.tree.map(np.asarray, state.params), met, jax.tree.map(np.asarray, adam.mu)


# --- comparisons -----------------------------------------------------------------------


def rank_slices(global_tree, axes, strategy, rank, spec_tree=None):
    """Rank `rank`'s local slices of a global numpy tree under the placement
    rules (`sharding.place_params` on a mesh without process groups)."""
    mesh = tmesh.Mesh(dict(axes), rank=rank)
    t = convert._tensors(global_tree, torch.device("cpu"))
    return _np_tree(tp.local_tree(tsharding.place_params(t, mesh, strategy, _spec=spec_tree)))


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    elif a is not None:
        yield path, np.asarray(a, np.float32), np.asarray(b, np.float32)


def assert_leaves(got, want, what, atol_max=LEAF_MAX, atol_p99=LEAF_P99):
    n = 0
    for path, g, w in _leaves(got, want):
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        d = np.abs(g - w).ravel()
        assert d.max() <= atol_max, (what, path, d.max() / LR)
        assert np.quantile(d, 0.99) <= atol_p99, (what, path, np.quantile(d, 0.99) / LR)
        n += 1
    assert n > 0, what


def mu_slices(mu, tree, axes, strategy, rank):
    """Rank `rank`'s slices of a global first-moment tree, laid out as the
    sharded step lays out its moments (`shard_train_state`: under zero2 split
    on fsdp where the parameters are not)."""
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), tree)
    spec = tsharding.shard_train_state(tstate.TrainState.create(tree, opt), tmesh.Mesh(dict(axes)),
                                       strategy).opt_state.mu
    return rank_slices(mu, axes, strategy, rank, spec_tree=spec)


def assert_moments(got, want, what, rel):
    """Each leaf's first Adam moment (its clipped gradient times 1 - b1)
    within `rel` of `want`'s in norm, relative to `want`'s norm; a leaf
    whose moment is zero (a frozen one) zero too."""
    n = 0
    for path, g, w in _leaves(got, want):
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        wn = float(np.linalg.norm(w.astype(np.float64)))
        d = float(np.linalg.norm(g.astype(np.float64) - w))
        assert d <= rel * wn if wn else d == 0, (what, path, d, wn)
        n += 1
    assert n > 0, what


def assert_metrics(got, want, what):
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_REL), what
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=GN_REL), what
    assert got["action_accuracy"] == want["action_accuracy"], what
    assert got["l1_loss"] == pytest.approx(want["l1_loss"], abs=1e-5), what
    np.testing.assert_allclose(got["per_example_loss"], want["per_example_loss"], rtol=LOSS_REL,
                               err_msg=what)


@pytest.fixture(scope="module")
def full():
    """Both sides' full-parameter runs: JAX's one-device step, JAX's sharded
    step a mesh, the port's one-process step, and every port rank of every
    mesh (one spawn of four ranks)."""
    import jax

    from openvla_probe_tpu.models import vlm as jvlm

    jcfg = jax_cfg()
    jparams = jvlm.init_params(jcfg, jax.random.key(0))
    nparams = jax.tree.map(np.asarray, jparams)
    cfg = train_cfg(jcfg)
    params = convert.params_from_jax(nparams, cfg, device="cpu")
    b = np_batch(jcfg.llm.vocab_size, jcfg.vision[0].image_size)
    tb = torch_batch(b)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:   # the ranks beside the JAX side
        ranks = pool.submit(D.run_ranks, rank_full, 4, (params, cfg, tb, MESHES),
                            timeout=RANK_TIMEOUT, device="cpu")
        out = jax_side(jparams, jcfg, b)
        out["ranks"] = ranks.result()
    codec = TCodec(vocab_size=cfg.llm.vocab_size)
    one = {}
    for masked in (False, True):
        opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), params)
        fn = tstep.make_train_step(cfg, opt, codec,
                                   trainable_mask=layer_mask(params, True) if masked else None)
        s, m = fn(tstate.TrainState.create(params, opt), tb)
        one[masked] = (_np_tree(s.params), _metrics(m), _np_tree(s.opt_state.mu))
    out["one_port"] = one
    out["init"] = nparams
    out["params"] = params
    return out


def jax_side(jparams, jcfg, b) -> dict:
    """JAX's one-device step and its sharded step at every mesh."""
    return {"one_jax": jax_step(jparams, jcfg, b),
            "sharded_jax": [jax_step(jparams, jcfg, b, axes, strategy)
                            for axes, strategy, _ in MESHES[:JAX_SHARDED]]}


def test_batch_dp_shards_hold_unequal_valid_counts():
    """The batch's two dp shards: 5 and 14 valid next-token labels, so the
    mean of the two shards' means is not the global mean."""
    b = np_batch(512, 28)
    valid = b["labels"][:, 1:] != -100
    assert [int(valid[:2].sum()), int(valid[2:].sum())] == [5, 14]


@pytest.mark.parametrize("case", range(len(MESHES)),
                         ids=[f"{'x'.join(f'{k}{v}' for k, v in a.items())}-{s}{'-masked' if m else ''}"
                              for a, s, m in MESHES])
def test_sharded_step_matches_jax(full, case):
    axes, strategy, masked = MESHES[case]
    onew, omet, omu = full["one_jax"]
    pnew, pmet, pmu = full["one_port"][masked]
    jax_sharded = case < JAX_SHARDED
    moments = functools.partial(mu_slices, tree=full["params"], axes=axes, strategy=strategy)
    if jax_sharded:
        jnew, jmet, jmu = full["sharded_jax"][case]
        assert_metrics(jmet, omet, "JAX sharded vs JAX one device")
    for rank, res in enumerate(full["ranks"]):
        got = res[case]
        if jax_sharded:
            assert_metrics(got["metrics"], jmet, (axes, rank, "JAX sharded"))
            assert_leaves(got["params"], rank_slices(jnew, axes, strategy, rank),
                          (axes, rank, "JAX"))
            assert_moments(got["mu"], moments(jmu, rank=rank), (axes, rank, "JAX sharded mu"),
                           MU_REL)
        if not masked:   # the mask moves the step: JAX's one-device step runs without it
            assert_metrics(got["metrics"], omet, (axes, rank, "JAX one device"))
            assert_leaves(got["params"], rank_slices(onew, axes, strategy, rank),
                          (axes, rank, "JAX one device"))
            assert_moments(got["mu"], moments(omu, rank=rank), (axes, rank, "JAX one mu"),
                           MU_REL)
        assert_metrics(got["metrics"], pmet, (axes, rank, "port one process"))
        assert_leaves(got["params"], rank_slices(pnew, axes, strategy, rank),
                      (axes, rank, "port one process"))
        assert_moments(got["mu"], moments(pmu, rank=rank), (axes, rank, "port one mu"), MU_REL)
        if masked:   # frozen leaves, and the frozen layers of the trunk, bit-unchanged
            init = rank_slices(full["init"], axes, strategy, rank)
            for path, g, w in _leaves(got["params"], init):
                if path.startswith("/vision"):
                    assert np.array_equal(g, w), path
                elif "/layers/" in path:
                    assert np.array_equal(g[:3], w[:3]) and not np.array_equal(g[3], w[3]), path


def test_qlora_int8_dp2_tp2_matches_jax():
    """QLoRA over the int8 trunk and lm_head at dp 2 x tp 2, rank 64: every
    rank's loss, grad norm, metrics and adapters against the JAX package's
    sharded step and one-device step with `make_lora_loss_fn` (streamed)."""
    import jax
    import jax.numpy as jnp

    from openvla_probe_tpu.models import vlm as jvlm
    from openvla_probe_tpu.ops import linear as jlin
    from openvla_probe_tpu.training import lora as jlora
    from openvla_probe_tpu.training import train_step as jstep
    from openvla_probe_tpu.vla.action_tokenizer import ActionCodec
    from openvla_probe_tpu_torch.tools import bench_finetune as bf
    from tests.test_torch_training import _with_random_b

    jcfg = jax_cfg()
    V = jcfg.llm.vocab_size
    base = jlin.quantize_params(jvlm.init_params(jcfg, jax.random.key(0)),
                               suffixes=jlin._DEFAULT_QUANT_SUFFIXES, bits=8)
    nlora = jax.tree.map(np.asarray, _with_random_b(jlora.init_lora_params(
        base, jlora.LoRAConfig(r=QLORA_R), jax.random.key(1)), np.random.default_rng(5)))
    jlora_tree = jax.tree.map(jnp.asarray, nlora)
    jloss = jlora.make_lora_loss_fn(functools.partial(jstep.vla_loss_fn,
                                                      codec=ActionCodec(vocab_size=V)),
                                    base, jlora.LoRAConfig(r=QLORA_R), stream=True)
    b = np_batch(V, jcfg.vision[0].image_size)
    cfg = bf.train_config(convert.config_from_jax(jcfg), "int8")
    tbase = convert.params_from_jax(jax.tree.map(np.asarray, base), cfg, device="cpu",
                                    quant_suffixes=jlin._DEFAULT_QUANT_SUFFIXES, bits=8)
    tlora_tree = convert.lora_from_jax(nlora, device="cpu")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:   # the ranks beside the JAX side
        ranks = pool.submit(D.run_ranks, rank_qlora, 4,
                            (tbase, tlora_tree, cfg,
                             torch_batch(b), QLORA_MESH, "tp"), timeout=RANK_TIMEOUT,
                            device="cpu")
        jnew, jmet, jmu = jax_step(jlora_tree, jcfg, b, QLORA_MESH, "tp", loss_fn=jloss)
        _, omet, omu = jax_step(jlora_tree, jcfg, b, loss_fn=jloss)
        ranks = ranks.result()
    assert_metrics(jmet, omet, "JAX sharded vs JAX one device")
    split = {"B": 0, "A": 0}
    for rank, got in enumerate(ranks):
        assert_metrics(got["metrics"], jmet, (rank, "JAX sharded"))
        assert_metrics(got["metrics"], omet, (rank, "JAX one device"))
        want = rank_slices(jnew, QLORA_MESH, "tp", rank)
        assert_leaves(got["params"], want, (rank, "adapters"), QLORA_MAX, QLORA_P99)
        for mu, what in ((jmu, "qlora JAX sharded mu"), (omu, "qlora JAX one mu")):
            assert_moments(got["mu"], mu_slices(mu, tlora_tree, QLORA_MESH, "tp", rank),
                           (rank, what), QLORA_MU_REL)
        for path, g, w in _leaves(got["params"], nlora):
            if g.shape != w.shape:
                split[path[-1]] += 1
    # the rules split B over column-parallel bases (q, k, v, gate, up; both towers' fused
    # qkv, whose base they leave whole) and A over row-parallel ones (o, down), on every rank
    # (the projector's {w, b} factors: none, as in the JAX rule)
    assert split == {"B": 4 * 7, "A": 4 * 2}, split


def test_three_zero2_steps_on_two_ranks_equal_one_process():
    """Three zero2 steps on {"fsdp": 2} (the moments split, the parameters
    whole on each rank) against three one-process steps: loss and grad norm
    within 1e-6 relative, the parameters and each rank's moment shards
    within the leaf rule, step for step."""
    from openvla_probe_tpu.models import vlm as jvlm
    import jax

    jcfg = jax_cfg()
    cfg = train_cfg(jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jvlm.init_params(
        jcfg, jax.random.key(0))), cfg, device="cpu")
    b = torch_batch(np_batch(jcfg.llm.vocab_size, jcfg.vision[0].image_size))
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), params)
    fn = tstep.make_train_step(cfg, opt, TCodec(vocab_size=cfg.llm.vocab_size))
    state, want = tstate.TrainState.create(params, opt), []
    for _ in range(3):
        state, m = fn(state, b)
        want.append((_np_tree(state.params), _np_tree(state.opt_state.mu), _metrics(m)))
    ranks = D.run_ranks(rank_trajectory, 2, (params, cfg, b, 3), timeout=RANK_TIMEOUT,
                        device="cpu")
    axes = {"fsdp": 2}
    mu_spec = tsharding.shard_train_state(tstate.TrainState.create(params, opt),
                                          tmesh.Mesh(axes), "zero2").opt_state.mu
    for i, (wp, wmu, wm) in enumerate(want):
        for rank, res in enumerate(ranks):
            got = res[i]
            assert got["metrics"]["loss"] == pytest.approx(wm["loss"], rel=1e-6), (i, rank)
            assert got["metrics"]["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-6)
            assert_leaves(got["params"], wp, (i, rank, "params"))
            mu = rank_slices(wmu, axes, "fsdp", rank, spec_tree=mu_spec)
            assert_leaves(got["mu"], mu, (i, rank, "moments"), atol_max=1e-2 * LR,
                          atol_p99=1e-2 * LR)
    assert any(g.shape != w.shape for _, g, w in _leaves(ranks[0][0]["mu"], want[0][1]))


def _refusal(cfg, axes, **kw):
    mesh = tmesh.Mesh(dict(axes))
    state = tstate.TrainState.create({"w": torch.zeros(4, 4)}, tstate.make_optimizer(
        tstate.OptimizerConfig(), {"w": torch.zeros(4, 4)}))
    return tstep.make_sharded_train_step(cfg, None, mesh, tsharding.shard_train_state(
        state, mesh, "tp"), tmesh.data_sharding(mesh), **kw)


@pytest.mark.parametrize("case", ["ep", "moe", "phi", "pp", "grad_accum"])
def test_sharded_step_refuses_what_is_not_ported(case):
    from openvla_probe_tpu_torch.models import llama as tllama
    from openvla_probe_tpu_torch.models import phi as tphi
    from openvla_probe_tpu_torch.models import vlm as tvlm

    cfg, axes, kw, what = tvlm.VLMConfig.tiny(), {"dp": 2}, {}, None
    if case == "ep":
        axes, what = {"ep": 2}, "an ep axis of 2"
    elif case == "moe":
        cfg = dataclasses.replace(cfg, llm=tllama.LlamaConfig.tiny(moe_experts=4))
        what = "a MoE trunk"
    elif case == "phi":
        cfg = dataclasses.replace(cfg, llm=tphi.PhiConfig.tiny())
        what = "a Phi trunk"
    elif case == "pp":
        axes, what = {"pp": 2, "dp": 1}, "a pp axis"
    else:
        kw, what = {"grad_accum_steps": 2}, "grad_accum_steps=2"
    with pytest.raises(NotImplementedError, match=f"{what}.*item 14"):
        _refusal(cfg, axes, **kw)


def test_sharded_step_refuses_a_loss_that_skips_vla_loss_fn():
    """A loss that never reaches vla_loss_fn would run as a local mean that
    the data axes' SUM scales by their ranks: the step raises instead."""
    from openvla_probe_tpu_torch.models import vlm as tvlm

    params = {"w": torch.ones(4, 4)}
    mesh = tmesh.Mesh({"dp": 2})
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), params)
    state = tstate.TrainState.create(params, opt)
    step = tstep.make_sharded_train_step(
        tvlm.VLMConfig.tiny(), opt, mesh, tsharding.shard_train_state(state, mesh, "tp"),
        tmesh.data_sharding(mesh), loss_fn=lambda p, cfg, batch: ((p["w"] ** 2).sum(), {}))
    with pytest.raises(TypeError, match="never called vla_loss_fn"):
        step(tstep.place_train_state(state, mesh, "tp"), {"input_ids": torch.zeros(2, 3)})


def rank_sp_odd(rank, world, params, cfg, batch):
    mesh = tmesh.make_mesh({"sp": world})
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw()), params)
    state = tstate.TrainState.create(params, opt)
    step = tstep.make_sharded_train_step(
        cfg, opt, mesh, tsharding.shard_train_state(state, mesh, "tp"),
        tmesh.sequence_sharding(mesh, batch), codec=TCodec(vocab_size=cfg.llm.vocab_size))
    try:
        step(tstep.place_train_state(state, mesh, "tp"), batch)
    except ValueError as e:
        return str(e)
    return None


def test_spliced_length_not_dividing_by_sp_raises():
    """24 text tokens divide by sp = 2 (so `sequence_sharding` splits them),
    but with 42-pixel images each tower gives 9 patches, and the spliced
    sequence, 33 tokens, does not: it raises on every rank, naming it (the
    JAX package asks the caller to pad)."""
    from openvla_probe_tpu_torch.models import vlm as tvlm

    tiny = tvlm.VLMConfig.tiny()
    cfg = dataclasses.replace(tiny, llm=dataclasses.replace(tiny.llm, flash_attn=False),
                              vision=tuple(dataclasses.replace(v, flash_attn=False, image_size=42)
                                           for v in tiny.vision))
    params = convert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = torch_batch(np_batch(cfg.llm.vocab_size, 42, T=24))
    assert tmesh.sequence_sharding(tmesh.Mesh({"sp": 2}), b)["input_ids"] == (None, "sp")
    msgs = D.run_ranks(rank_sp_odd, 2, (params, cfg, b), timeout=RANK_TIMEOUT, device="cpu")
    for m in msgs:
        assert m is not None and "spliced length 33" in m and "sp=2" in m, m
