"""Two whole train steps, and gradient accumulation, of the port's training
slice against the JAX package's, on the CPU at tiny fp32 size: the routes,
environments, inputs and gradient tolerances of
``tests/test_torch_training.py``.

Tolerances, beyond that file's:
* the loss of the second step 3e-4 relative (found 3.2e-5): it is taken at
  adapters that the first step moved apart (below);
* the adapters after the steps: Adam's first steps move each element by
  about lr · sign(g), so an element whose gradient is near 0 on one side may
  move the other way on the other, and the rest move by lr times the
  gradients' relative difference: every element within 2 · lr per step, 90 %
  within 1e-2 · lr and 99 % within 1e-1 · lr (found after two steps: int4
  at most 1.76 lr, 90 % 1.8e-3 lr, 99 % 2.7e-2 lr; int8 2.02 lr, 3.2e-3 lr,
  5.6e-2 lr);
* the Adam moments after two steps within 2e-2 in norm: the second
  gradients are taken at adapters that already differ.
"""

import numpy as np

import jax

from openvla_probe_tpu.training import train_state as jstate
from openvla_probe_tpu.training import train_step as jstep
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.tools import bench_finetune as bf
from openvla_probe_tpu_torch.training import train_state as tstate
from openvla_probe_tpu_torch.training import train_step as tstep

from tests.test_torch_training import (GRAD_TOL, LOSS_TOL, LR, SEQ, _jax_batch, _pairs,  # noqa: F401
                                       assert_grads_close, build_route, jax_env, route)


def _optimizer_config(**kw):
    return dict(learning_rate=LR, lr_schedule_type="constant", max_steps=10, weight_decay=0.01,
                **kw)


def test_two_train_steps_match_jax(route):
    """make_train_step on both sides, two AdamW steps (clip at 1.0, decay on
    the >= 2-D adapters): loss, grad norm, adapters, optimizer state."""
    r = route
    jopt = jstate.make_optimizer(jstate.OptimizerConfig(**_optimizer_config()), r["lora"])
    jfn = jstep.make_train_step(r["jcfg"], jopt, loss_fn=lambda l, c, b: r["jloss"](
        l, r["base"], c, b), donate=False)
    with jax_env(r["env"]):
        js = jstate.TrainState.create(r["lora"], jopt)
        jmet = []
        for _ in range(2):
            js, m = jfn(js, r["jb"])
            jmet.append(m)
    topt = tstate.make_optimizer(tstate.OptimizerConfig(**_optimizer_config()), r["tlora"])
    tfn = tstep.make_train_step(r["tcfg"], topt, loss_fn=r["tloss"])
    ts = tstate.TrainState.create(r["tlora"], topt)
    tmet = []
    for _ in range(2):
        ts, m = tfn(ts, r["tb"])
        tmet.append(m)
    assert ts.step == 2 and ts.opt_state.count == 2
    for i, (jm, tm) in enumerate(zip(jmet, tmet)):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_TOL * (1, 3)[i])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    deltas = np.concatenate([np.abs(got - want).ravel()
                             for _, want, got in _pairs(js.params, ts.params)])
    assert deltas.max() <= 4 * LR
    assert np.quantile(deltas, 0.9) <= 1e-2 * LR and np.quantile(deltas, 0.99) <= 1e-1 * LR
    # the JAX optimizer state, converted, is the port's (moments to the grads' tolerance)
    conv = convert.opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state), device="cpu")
    assert conv.count == ts.opt_state.count
    for moment in ("mu", "nu"):
        for path, want, got in _pairs(getattr(conv, moment), getattr(ts.opt_state, moment)):
            assert_grads_close(got, want, f"{moment} {path}", tol=4 * GRAD_TOL)


def test_grad_accum_matches_jax():
    """grad_accum_steps=2 over 4 rows (two micro-batches of 2) on both sides,
    on the int8 route (the accumulation loop does not depend on the route)."""
    r = build_route("int8")
    tb = bf.synthetic_batch(r["tcfg"], 4, SEQ, 11, "cpu")
    jb = _jax_batch(tb)
    cfg = jstate.OptimizerConfig(**_optimizer_config())
    jopt = jstate.make_optimizer(cfg, r["lora"])
    jfn = jstep.make_train_step(r["jcfg"], jopt, loss_fn=lambda l, c, b: r["jloss"](
        l, r["base"], c, b), donate=False, grad_accum_steps=2)
    with jax_env(r["env"]):
        js, jm = jfn(jstate.TrainState.create(r["lora"], jopt), jb)
    topt = tstate.make_optimizer(tstate.OptimizerConfig(**_optimizer_config()), r["tlora"])
    tfn = tstep.make_train_step(r["tcfg"], topt, loss_fn=r["tloss"], grad_accum_steps=2)
    ts, tm = tfn(tstate.TrainState.create(r["tlora"], topt), tb)
    assert "per_example" not in tm
    for k in ("loss", "action_accuracy", "l1_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    deltas = np.concatenate([np.abs(got - want).ravel()
                             for _, want, got in _pairs(js.params, ts.params)])
    assert deltas.max() <= 2 * LR
    assert np.quantile(deltas, 0.9) <= 1e-2 * LR and np.quantile(deltas, 0.99) <= 1e-1 * LR
