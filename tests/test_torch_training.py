"""The port's training slice vs the JAX package, on the CPU at tiny fp32 size.

Two routes, each as the JAX package runs it (environment set through
monkeypatch only, every other ``OVLA_*`` unset, restored afterwards):

* ``int4``: ``quantize_params(bits=4)`` over the trunk and lm_head, towers and
  projector fp32; JAX with ``OVLA_PALLAS=1``, ``OVLA_PALLAS_INTERPRET=1``,
  ``OVLA_PALLAS_ATTN=0`` inside ``force_tpu_interpret_mode()``: every trunk
  linear on ``_w4a8_pallas_dot`` (forward kernel, dx kernel backward), lm_head
  (vocab 400, no 128 tile) on the requant forward with the bf16-dequant dx;
  the config is ``tests/test_torch_int4.py::int4_vlm`` (in-dims whose groups
  are 128 wide: interpret mode drops the chip's ``gsz % 128`` rule);
* ``int8``: ``quantize_params(bits=8)`` over the trunk and lm_head on
  ``VLMConfig.tiny()``; JAX with no ``OVLA_*`` set: ``_w8a8_dot`` and its STE.

Streamed LoRA (r = 4, alpha 4) with B drawn N(0, 0.02) so that every factor
has a gradient; numpy-seeded batch of 3 rows of 12 text tokens (7 action
labels and the stop token).

Tolerances:
* loss and metrics: 1e-4 relative (found: int4 equal, int8 1.2e-5): an int8
  activation code at a rounding tie may land one step apart between the two
  sides' fp32 sums;
* every LoRA-leaf gradient within 5e-3 in norm, and every element within
  2e-2 of the leaf's largest |g| (found up to 1.1e-2 on one element of 1024,
  int8 gate_proj A): each STE backward rounds its scaled gradient (int4:
  g · s; int8: g) to bf16, and the fp32 sums of XLA and PyTorch differ in
  their last bits, which moves some of those roundings by one bf16 step
  (2^-8 relative) upstream of every quantized linear;
* the optimizer alone against optax, fed the same gradients: 1e-6 relative
  (the same fp32 operations; ``b^t`` may differ by an ulp).

Two whole steps and gradient accumulation: ``tests/test_torch_training_steps.py``.
"""

import contextlib
import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.training import lora as jlora
from openvla_probe_tpu.training import train_state as jstate
from openvla_probe_tpu.training import train_step as jstep
from openvla_probe_tpu.vla.action_tokenizer import ActionCodec as JCodec
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.tools import bench_finetune as bf
from openvla_probe_tpu_torch.training import checkpointing as ckpt
from openvla_probe_tpu_torch.training import lora as tlora
from openvla_probe_tpu_torch.training import train_state as tstate
from openvla_probe_tpu_torch.training import train_step as tstep
from openvla_probe_tpu_torch.training.preemption import PreemptionGuard
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec as TCodec

from tests.test_torch_int4 import int4_vlm

R, BATCH, SEQ, LR = 4, 3, 12, 5e-4
LOSS_TOL = 1e-4
GRAD_TOL = 5e-3
ROUTES = {"int4": (4, {"OVLA_PALLAS": "1", "OVLA_PALLAS_INTERPRET": "1",
                       "OVLA_PALLAS_ATTN": "0"}),
          "int8": (8, {})}


@contextlib.contextmanager
def jax_env(env):
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for k in [k for k in os.environ if k.startswith("OVLA_")]:
            mp.delenv(k)
        for k, v in env.items():
            mp.setenv(k, v)
        yield


def _is_ab(x):
    return isinstance(x, dict) and set(x) == {"A", "B"}


def _with_random_b(lora, rng):
    if _is_ab(lora):
        return {"A": lora["A"], "B": jnp.asarray(rng.normal(0, 0.02, lora["B"].shape), jnp.float32)}
    if isinstance(lora, dict):
        return {k: _with_random_b(v, rng) for k, v in lora.items()}
    return lora


def _pairs(jtree, ttree, path=""):
    """(path, jax array, torch tensor) over the adapter leaves of two trees."""
    if ttree is None:
        return []
    if _is_ab(ttree):
        return [(f"{path}/{k}", np.asarray(jtree[k]), ttree[k].detach().numpy()) for k in "AB"]
    return [p for k in ttree for p in _pairs(jtree[k], ttree[k], f"{path}/{k}")]


def _jax_batch(tb):
    return {k: jnp.asarray(v.numpy().astype(np.float32 if k == "pixel_values" else np.int32))
            for k, v in tb.items()}


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    return build_route(request.param)


def build_route(quant):
    """Both sides' model, base, adapters, batch and loss for one route."""
    bits, env = ROUTES[quant]
    jcfg = int4_vlm() if quant == "int4" else jvlm.VLMConfig.tiny()
    base = jlin.quantize_params(jvlm.init_params(jcfg, jax.random.key(0)),
                                suffixes=jlin._DEFAULT_QUANT_SUFFIXES, bits=bits)
    tcfg = bf.train_config(convert.config_from_jax(jcfg), quant)
    tbase = convert.params_from_jax(jax.tree.map(np.asarray, base), tcfg, device="cpu",
                                    quant_suffixes=jlin._DEFAULT_QUANT_SUFFIXES, bits=bits)
    lcfg = jlora.LoRAConfig(r=R)
    lora = _with_random_b(jlora.init_lora_params(base, lcfg, jax.random.key(1)),
                          np.random.default_rng(5))
    tb = bf.synthetic_batch(tcfg, BATCH, SEQ, 7, "cpu")
    V = jcfg.llm.vocab_size
    jloss = jlora.make_lora_loss_with_base(
        functools.partial(jstep.vla_loss_fn, codec=JCodec(vocab_size=min(V, 32000))), lcfg)
    tloss = tlora.make_lora_loss_fn(
        functools.partial(tstep.vla_loss_fn, codec=TCodec(vocab_size=min(V, 32000))), tbase,
        tlora.LoRAConfig(r=R), stream=True)
    return dict(quant=quant, env=env, jcfg=jcfg, tcfg=tcfg, base=base, tbase=tbase, lora=lora,
                tlora=convert.lora_from_jax(jax.tree.map(np.asarray, lora), device="cpu"),
                jb=_jax_batch(tb), tb=tb, jloss=jloss, tloss=tloss)


@pytest.fixture(scope="module")
def grads(route):
    r = route
    with jax_env(r["env"]):
        fn = jax.jit(jax.value_and_grad(lambda l, b, batch: r["jloss"](l, b, r["jcfg"], batch),
                                        has_aux=True))
        (jl, jm), jg = fn(r["lora"], r["base"], r["jb"])
    _build.reset_launch_counts()
    (tl, tm), tg = tstep.value_and_grad(r["tloss"], r["tlora"], r["tcfg"], r["tb"])
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}     # the CPU launches no kernel
    return (jl, jm, jg), (tl, tm, tg)


def test_config_from_jax_carries_remat():
    """``remat`` is a field on both sides; ``flash_attn`` is the JAX
    package's environment gate, a field the caller sets (the trainer: off)."""
    j = jvlm.VLMConfig.tiny()
    j = dataclasses.replace(j, llm=dataclasses.replace(j.llm, remat=True),
                            vision=tuple(dataclasses.replace(v, remat=True) for v in j.vision))
    t = convert.config_from_jax(j)
    assert t.llm.remat and all(v.remat for v in t.vision)
    assert t.llm.flash_attn and all(v.flash_attn for v in t.vision)
    trained = bf.train_config(t, "int4")
    assert not trained.llm.flash_attn and not any(v.flash_attn for v in trained.vision)
    assert (trained.llm.int8_matmul, trained.llm.fused_rmsq) == ("wi8", False)
    assert bf.train_config(t, "int8").llm.int8_matmul == "w8a8"


def test_loss_and_metrics_match_jax(grads):
    (jl, jm, _), (tl, tm, _) = grads
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    for k in ("action_accuracy", "l1_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    for k in ("loss", "action_accuracy", "l1_loss"):
        np.testing.assert_allclose(tm["per_example"][k].numpy(), np.asarray(jm["per_example"][k]),
                                   rtol=LOSS_TOL, atol=1e-6)


def test_every_lora_grad_matches_jax(grads):
    (_, _, jg), (_, _, tg) = grads
    pairs = _pairs(jg, tg)
    assert len(pairs) > 20
    for path, want, got in pairs:
        assert got.shape == want.shape, path
        assert np.abs(want).max() > 0, path
        assert_grads_close(got, want, path)


def assert_grads_close(got, want, what, tol=GRAD_TOL):
    """Within `tol` in norm, and every element within 4 `tol` of the largest
    |want| (module docstring)."""
    scale = np.abs(want).max()
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), what
    np.testing.assert_allclose(got, want, atol=4 * tol * scale, rtol=0, err_msg=what)


def test_remat_gives_the_same_grads(route):
    """remat on (the trainer's setting) and off: the same function, recomputed."""
    r = route
    off = dataclasses.replace(
        r["tcfg"], llm=dataclasses.replace(r["tcfg"].llm, remat=False),
        vision=tuple(dataclasses.replace(v, remat=False) for v in r["tcfg"].vision))
    assert r["tcfg"].llm.remat and all(v.remat for v in r["tcfg"].vision)
    (l_on, _), g_on = tstep.value_and_grad(r["tloss"], r["tlora"], r["tcfg"], r["tb"])
    (l_off, _), g_off = tstep.value_and_grad(r["tloss"], r["tlora"], off, r["tb"])
    assert torch.equal(l_on, l_off)
    for a, b in zip(tstate.tree_leaves(g_on), tstate.tree_leaves(g_off)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- the optimizer alone ---------------------------------------------------------------


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 5), "b": (5,), "stack": {"q": (2, 3, 4), "norm": (2, 3)}}

    def make(s, scale):
        if isinstance(s, dict):
            return {k: make(v, scale) for k, v in s.items()}
        return rng.normal(0, scale, s).astype(np.float32)

    return make(shapes, 1.0), [make(shapes, g) for g in (0.3, 3.0, 0.05)]


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t):
    return {k: _to_torch(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(t)


def _flat(t, prefix=""):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)}


@pytest.mark.parametrize("schedule", ["linear-warmup+cosine-decay", "constant"])
def test_optimizer_matches_optax(schedule):
    """Three steps of the same gradients through both chains: global-norm
    clipping (the second gradients' norm is past 1), Adam, decay on >= 2-D
    leaves only, the schedule last; warmup-cosine has lr = 0 at step 0, so
    the first step leaves the params as they were."""
    params, grads = _opt_trees(0)
    cfg = dict(learning_rate=1e-2, lr_schedule_type=schedule, max_steps=20, warmup_ratio=0.1,
               weight_decay=0.1)
    jopt = jstate.make_optimizer(jstate.OptimizerConfig(**cfg), _to_jax(params))
    topt = tstate.make_optimizer(tstate.OptimizerConfig(**cfg), _to_torch(params))
    js = jstate.TrainState.create(_to_jax(params), jopt)
    ts = tstate.TrainState.create(_to_torch(params), topt)
    for i, g in enumerate(grads):
        js = jstate.apply_gradients(js, _to_jax(g), jopt)
        ts = tstate.apply_gradients(ts, _to_torch(g), topt)
        got, want = _flat(ts.params), _flat(js.params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=f"{i} {k}")
        if i == 0 and schedule != "constant":
            for k, v in _flat(params).items():
                np.testing.assert_array_equal(got[k], v)
    conv = convert.opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state), device="cpu")
    assert conv.count == ts.opt_state.count == 3
    for moment in ("mu", "nu"):
        got, want = _flat(getattr(ts.opt_state, moment)), _flat(getattr(conv, moment))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12)


def test_schedule_matches_optax():
    cfg = dict(learning_rate=3e-4, max_steps=50, warmup_ratio=0.1, final_lr_ratio=0.05)
    js = jstate.make_schedule(jstate.OptimizerConfig(**cfg))
    ts = tstate.make_schedule(tstate.OptimizerConfig(**cfg))
    for count in (0, 1, 4, 5, 6, 27, 49, 50, 60):
        np.testing.assert_allclose(float(ts(count)), float(js(count)), rtol=1e-6, atol=1e-12)
    assert float(ts(0)) == 0.0


def test_adafactor_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 13"):
        tstate.make_optimizer(tstate.OptimizerConfig(optimizer_type="adafactor"), {})


def test_trainable_mask_freezes_leaves_like_jax():
    """A frozen leaf moves neither by its gradient nor by weight decay; a
    [L] layer mask freezes the layers it zeroes. A quadratic loss through both
    steps."""
    params, _ = _opt_trees(1)
    x = np.random.default_rng(2).normal(size=(4, 5)).astype(np.float32)
    mask = {"w": True, "b": False, "stack": {"q": np.array([True, False]), "norm": True}}

    def jloss(p, cfg, batch):
        l = (jnp.sum((p["w"] * batch["x"]) ** 2) + jnp.sum(p["b"] ** 2)
             + jnp.sum(p["stack"]["q"] ** 2) + jnp.sum(p["stack"]["norm"] ** 3))
        return l, {"loss": l}

    def tloss(p, cfg, batch):
        l = (torch.sum((p["w"] * batch["x"]) ** 2) + torch.sum(p["b"] ** 2)
             + torch.sum(p["stack"]["q"] ** 2) + torch.sum(p["stack"]["norm"] ** 3))
        return l, {"loss": l.detach()}

    cfg = jstate.OptimizerConfig(learning_rate=1e-2, lr_schedule_type="constant", weight_decay=0.5)
    jopt = jstate.make_optimizer(cfg, _to_jax(params))
    jfn = jstep.make_train_step(None, jopt, loss_fn=jloss, trainable_mask=mask, donate=False)
    js, jm = jfn(jstate.TrainState.create(_to_jax(params), jopt), {"x": jnp.asarray(x)})
    tmask = {"w": True, "b": False, "stack": {"q": torch.tensor([True, False]), "norm": True}}
    topt = tstate.make_optimizer(tstate.OptimizerConfig(**dataclasses.asdict(cfg)),
                                 _to_torch(params))
    tfn = tstep.make_train_step(None, topt, loss_fn=tloss, trainable_mask=tmask)
    ts, tm = tfn(tstate.TrainState.create(_to_torch(params), topt), {"x": torch.from_numpy(x)})
    got, want = _flat(ts.params), _flat(js.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["/b"], params["b"])
    np.testing.assert_array_equal(got["/stack/q"][1], params["stack"]["q"][1])
    assert not np.array_equal(got["/stack/q"][0], params["stack"]["q"][0])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)


# --- checkpoints and preemption ---------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    params, grads = _opt_trees(3)
    opt = tstate.make_optimizer(tstate.OptimizerConfig(), _to_torch(params))
    state = tstate.apply_gradients(tstate.TrainState.create(_to_torch(params), opt),
                                   _to_torch(grads[0]), opt)
    state = state._replace(params={**state.params, "none": None})
    for step, loss in ((5, 1.25), (12, 0.5), (9, float("nan"))):
        path = ckpt.save_checkpoint(tmp_path, state, step=step, epoch=1, loss=loss, keep_limit=2)
        assert ckpt.parse_checkpoint_name(path.name)[:2] == (step, 1)
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["step-000009-epoch-01-loss=0.0000", "step-000012-epoch-01-loss=0.5000"]
    latest = ckpt.latest_checkpoint(tmp_path)
    assert latest.name == "step-000012-epoch-01-loss=0.5000"
    back = ckpt.load_checkpoint(latest, template=state)
    assert isinstance(back, tstate.TrainState) and isinstance(back.opt_state, tstate.OptState)
    assert back.step == state.step and back.opt_state.count == 1 and back.params["none"] is None
    for name in ("params", "mu", "nu"):
        pick = (lambda s: s.params) if name == "params" else (
            lambda s: getattr(s.opt_state, name))
        for a, b in zip(tstate.tree_leaves(pick(state)), tstate.tree_leaves(pick(back))):
            assert torch.equal(a, b), name
    assert ckpt.parse_checkpoint_name("not-a-checkpoint") is None
    ckpt.save_run_config(tmp_path, {"lr": 5e-4, "dtype": torch.float32})
    assert ckpt.load_run_config(tmp_path) == {"lr": 5e-4, "dtype": "torch.float32"}


def test_async_writer_keeps_the_snapshot_and_prunes(tmp_path):
    t = {"x": torch.zeros(3)}
    with ckpt.AsyncCheckpointWriter(keep_limit=2) as writer:
        for step in (1, 2, 3):
            writer.save(tmp_path, t, step=step)
            t["x"] += 1                  # the loop moves on: each checkpoint keeps its step's value
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == [ckpt.checkpoint_name(2), ckpt.checkpoint_name(3)]
    for step, value in ((2, 1.0), (3, 2.0)):
        back = ckpt.load_checkpoint(tmp_path / "checkpoints" / ckpt.checkpoint_name(step))
        assert torch.equal(back["x"], torch.full((3,), value))
    assert ckpt.latest_checkpoint(tmp_path / "missing") is None


def test_preemption_guard_turns_a_signal_into_an_exit():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
        assert not guard.should_exit(0)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted and guard.should_exit(1) and guard.should_exit(2)
    assert signal.getsignal(signal.SIGTERM) is before
