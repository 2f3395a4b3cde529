"""Training the port's sparse-MoE trunk against the JAX package's, on the CPU
at tiny sizes: the backward of the grouped expert product
(`ops.expert_ragged`'s dx and dW, their plain versions here), the sorted
dispatch's gradients, streamed LoRA over int8 experts, the router losses in
the loss, remat, accumulation and whole train steps.

The JAX side is XLA on the CPU (``jax.vjp`` / ``jax.grad`` through
``lax.ragged_dot_general``), as ``tests/test_moe.py`` runs it; no OVLA_*
variable is set (the MoE trunk has no Pallas kernel).

Tolerances:
* dx and dW of one grouped product: fp32 within 1e-5 of the largest |want|
  (the same fp32 products summed in another order); bf16 every element
  within one bf16 step of want (the step at the larger magnitude, floored
  at 2^-10 of the largest |want|: both sides round one fp32 sum once), the
  LoRA form's dx within two (its base and adapter contributions are added
  in bf16 after each rounds once);
* the MoE FFN's gradients: against JAX 1e-5 relative plus 1e-6 of the
  largest |want| (fp32 sums in another order); against the port's einsum
  dispatch at dropless capacity JAX's own test_moe.py bound (2e-4 + 1e-3
  relative);
* streamed LoRA over int8 experts: every adapter gradient within 1e-5 in
  norm in fp32; in bf16 within 2e-2 in norm (each product rounds its fp32
  sums to bf16, and the two frameworks' sum orders move some of those
  roundings by a step, which the chain then carries);
* the loss and the router losses 1e-5 relative;
* two full fine-tune steps: losses 1e-5 relative, parameters after the steps
  within 2 lr everywhere and 99 % within 1e-2 lr (Adam moves each element
  by about lr · sign(g), so an element whose gradient is near 0 may take the
  other sign);
* remat on and off: equal gradients, bit for bit; accumulation over two
  micro-batches against the full batch: the gradients' norm within 1e-5
  relative (fp32 sums in another order), the parameters after the step by
  the Adam rule above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import moe as jmoe
from openvla_probe_tpu.models import phi as jphi
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.training import lora as jlora
from openvla_probe_tpu.training import train_state as jstate
from openvla_probe_tpu.training import train_step as jstep
from openvla_probe_tpu.vla.action_tokenizer import ActionCodec as JCodec
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import moe as tmoe
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import expert_ragged as texr
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.tools import bench_finetune as bf
from openvla_probe_tpu_torch.training import lora as tlora
from openvla_probe_tpu_torch.training import train_state as tstate
from openvla_probe_tpu_torch.training import train_step as tstep
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec as TCodec

from tests.test_torch_moe import JNP_DT, _layer, _np, _t

E, M, I, O, R = 4, 24, 32, 40, 8
LR = 5e-3


def assert_steps(got, want, dtype, steps=1, what=""):
    """fp32: within 1e-5 of the largest |want|; bf16: within `steps` bf16
    steps at the larger magnitude (floored at 2^-10 of the largest |want|)."""
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= 1e-5 * scale, (what, d.max(), scale)
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), scale * 2.0 ** -10)
    step = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (d <= steps * step).all(), (what, (d / step).max())


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# --- one grouped product: dx and dW --------------------------------------------------

SIZES = {"skewed_one_empty": [9, 0, 11, 4], "one_expert_all_rows": [0, 24, 0, 0],
         "rows_past_sum": [3, 0, 7, 2]}


def _e_row(sizes):
    e = np.repeat(np.arange(E), sizes)
    return jnp.asarray(np.concatenate([e, np.zeros(M - len(e), np.int64)]), jnp.int32)


def _weight(form, dtype, rng):
    """A JAX expert leaf [E, O, I] in `form` and the port's (int4 packed)."""
    w = rng.normal(size=(E, O, I)) * 0.2
    if form == "float":
        j = jnp.asarray(w, JNP_DT[dtype])
        return j, _t(j, dtype)
    jq = jlin.quantize_params({"gate_proj": jnp.asarray(w, jnp.float32)},
                              bits=4 if form == "int4" else 8, group_size=16)["gate_proj"]
    if form == "int4":
        codes = np.array(jnp.asarray(jq["q"]).astype(jnp.int8))
        tq = {"q": tlin.pack_int4(torch.from_numpy(codes)), "s": _t(jq["s"])}
    else:
        tq = {"q": torch.from_numpy(np.array(jq["q"])), "s": _t(jq["s"])}
    if form != "lora":
        return jq, tq
    A = rng.normal(size=(E, R, I)) * 0.3
    B = rng.normal(size=(E, O, R)) * 0.3
    return ({"base": jq, "A": jnp.asarray(A, jnp.float32), "B": jnp.asarray(B, jnp.float32)},
            {"base": tq, "A": torch.tensor(A, dtype=torch.float32),
             "B": torch.tensor(B, dtype=torch.float32)})


@pytest.mark.parametrize("sizes", list(SIZES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["float", "int8", "int4", "lora"])
def test_backward_matches_jax_vjp(form, dtype, sizes):
    """dx (every form) and dW (the float stack; the LoRA form's A and B)
    through `_ExpertRaggedFn` on CPU tensors (the plain dx and dW) against
    jax.vjp of `_expert_ragged`; rows past the sum give dx 0."""
    rng = np.random.default_rng(list(SIZES).index(sizes) * 8 + len(form))
    gs = SIZES[sizes]
    jw, tw = _weight(form, dtype, rng)
    jx = jnp.asarray(rng.normal(size=(M, I)), JNP_DT[dtype])
    jdy = jnp.asarray(rng.normal(size=(M, O)), JNP_DT[dtype])
    jgs, e_row = jnp.asarray(gs, jnp.int32), _e_row(gs)

    def with_params(x, *p):
        w = jw
        if form == "float":
            w = p[0]
        elif form == "lora":
            w = {"base": jw["base"], "A": p[0], "B": p[1]}
        return jmoe._expert_ragged(x, w, jgs, e_row)

    primals = [jx] + ([jw] if form == "float" else [jw["A"], jw["B"]] if form == "lora" else [])
    _, vjp = jax.vjp(with_params, *primals)
    want = vjp(jdy)

    tx = _t(jx, dtype).requires_grad_(True)
    params = ([tw.requires_grad_(True)] if form == "float" else
              [tw["A"].requires_grad_(True), tw["B"].requires_grad_(True)] if form == "lora"
              else [])
    leaf = {"base": tw["base"], "A": params[0], "B": params[1]} if form == "lora" else tw
    _build.reset_launch_counts()
    y = texr.expert_ragged(tx, leaf, torch.tensor(gs, dtype=torch.int32))
    got = torch.autograd.grad(y, [tx, *params], _t(jdy, dtype))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}
    assert bool((got[0][sum(gs):] == 0).all())
    assert_steps(got[0], want[0], dtype, steps=2 if form == "lora" else 1, what="dx")
    for name, g, w in zip(("dW", "dB") if form == "float" else ("dA", "dB"), got[1:], want[1:]):
        assert g.dtype == params[0].dtype
        assert_steps(g, w, dtype, what=name)


def test_plain_versions_on_their_own():
    """The two plain versions against fp64 sums of their definitions: an
    empty expert gets dW 0, rows past the sum take no part and get dx 0, and
    codes take dy · s first."""
    rng = np.random.default_rng(3)
    gs = torch.tensor([5, 0, 9, 3], dtype=torch.int32)
    dy = torch.tensor(rng.normal(size=(M, O)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(M, I)), dtype=torch.float32)
    q = torch.tensor(rng.integers(-127, 128, (E, O, I)), dtype=torch.int8)
    s = torch.tensor(rng.random((E, O)) * 1e-2, dtype=torch.float32)
    dx = texr.expert_ragged_dx_plain(dy, q, s, gs)
    dw = texr.expert_ragged_dw_plain(dy, x, gs, E)
    start = 0
    for e, n in enumerate(gs.tolist()):
        rows = slice(start, start + n)
        want_dx = (dy[rows].double() * s[e].double()) @ q[e].double()
        np.testing.assert_allclose(dx[rows].numpy(), want_dx.numpy(), rtol=1e-5, atol=1e-6)
        want_dw = dy[rows].double().t() @ x[rows].double()
        np.testing.assert_allclose(dw[e].numpy(), want_dw.numpy(), rtol=1e-5, atol=1e-5)
        start += n
    assert bool((dw[1] == 0).all()) and bool((dx[start:] == 0).all())


# --- the sorted dispatch's gradients ---------------------------------------------------


@pytest.mark.parametrize("with_valid", [False, True], ids=["all_valid", "pads"])
def test_sorted_ffn_grads_match_jax_and_einsum(with_valid):
    """Gradients of the router, the float expert stacks and h through
    moe_ffn_sorted (x[tok], the gate products, the inverse-permutation
    gather) against JAX's moe_ffn_sorted, and against the port's einsum
    dispatch at dropless capacity (JAX tests/test_moe.py's check)."""
    jlp, tlp = _layer(21)
    h = np.random.default_rng(22).normal(size=(2, 5, 16))
    valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32) if with_valid else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)

    def jloss(lp, h):
        y, aux = jmoe.moe_ffn_sorted(lp, h, top_k=2, token_valid=jvalid)
        return (y ** 2).sum() + aux[0] + aux[1]

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jlp, jnp.asarray(h, jnp.float32))

    def tgrads(fn, **kw):
        lp = {k: v.clone().requires_grad_(True) for k, v in tlp.items()}
        th = torch.tensor(h, dtype=torch.float32, requires_grad=True)
        y, aux = fn(lp, th, top_k=2, token_valid=tvalid, **kw)
        loss = (y ** 2).sum() + aux[0] + aux[1]
        g = torch.autograd.grad(loss, [*lp.values(), th])
        return dict(zip([*lp, "h"], g))

    got = tgrads(tmoe.moe_ffn_sorted)
    einsum = tgrads(tmoe.moe_ffn, capacity=10)
    for k in (*tlp, "h"):
        w = _np(want[1] if k == "h" else want[0][k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
        np.testing.assert_allclose(_np(got[k]), _np(einsum[k]), atol=2e-4, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_lora_over_int8_experts_grads_match_jax(dtype):
    """int8 experts (quantize_params) under streamed LoRA, the adapters made
    by JAX's init_lora_params (B random) and carried by convert.lora_from_jax;
    the router not adapted. The adapters' gradients and h's against JAX's."""
    jlp, _ = _layer(23)
    jbase = jlin.quantize_params(jlp)
    lcfg = jlora.LoRAConfig(r=4)
    rng = np.random.default_rng(24)
    jl = jlora.init_lora_params(jbase, lcfg, jax.random.key(3))
    assert jl["router"] is None
    jl = {k: None if v is None else {"A": v["A"], "B": jnp.asarray(
        rng.normal(size=v["B"].shape) * 0.2, jnp.float32)} for k, v in jl.items()}
    tl = convert.lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    tbase = {k: v if k == "router" else {"q": torch.from_numpy(np.array(v["q"])), "s": _t(v["s"])}
             for k, v in jbase.items()}
    tbase["router"] = _t(jbase["router"])
    h = rng.normal(size=(2, 6, 16))

    def jloss(lora, h):
        y, aux = jmoe.moe_ffn_sorted(jlora.attach_lora(jbase, lora, lcfg), h, top_k=2)
        return (y.astype(jnp.float32) ** 2).sum() + aux[0] + aux[1]

    jh = jnp.asarray(h, JNP_DT[dtype])
    want_l, want_h = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jl, jh)
    ab = [tl[k][n].requires_grad_(True) for k in ("gate_proj", "up_proj", "down_proj")
          for n in "AB"]
    th = _t(jh, dtype).requires_grad_(True)
    y, aux = tmoe.moe_ffn_sorted(tlora.attach_lora(tbase, tl, tlora.LoRAConfig(r=4)), th, top_k=2)
    got = torch.autograd.grad((y.float() ** 2).sum() + aux[0] + aux[1], [*ab, th])
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, (k, n) in zip(got, [(k, n) for k in ("gate_proj", "up_proj", "down_proj")
                               for n in "AB"]):
        assert g.dtype == torch.float32 and g.abs().max() > 0, (k, n)
        assert _rel(g, want_l[k][n]) <= tol, (k, n, _rel(g, want_l[k][n]))
    assert _rel(got[-1], want_h) <= tol


# --- the tiny MoE VLM: loss, steps, remat, accumulation -------------------------------


@pytest.fixture(scope="module")
def moe_vlm():
    """A tiny MoE VLM (4 experts, top-2, dropless), its JAX and port params
    and configs, a batch of 2 rows of 12 tokens."""
    jcfg = jvlm.VLMConfig.tiny(llm=jllama.LlamaConfig.tiny(moe_experts=4,
                                                         moe_capacity_factor=100.0))
    params = jax.jit(functools.partial(jvlm.init_params, jcfg))(jax.random.key(0))
    tcfg = convert.config_from_jax(jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    # under grad the port takes the plain attention (the JAX package's XLA branch here)
    tcfg = dataclasses.replace(
        tcfg, llm=dataclasses.replace(tcfg.llm, flash_attn=False),
        vision=tuple(dataclasses.replace(c, flash_attn=False) for c in tcfg.vision))
    tb = bf.synthetic_batch(tcfg, 2, 12, 7, "cpu")
    jb = {k: jnp.asarray(v.numpy().astype(np.float32 if k == "pixel_values" else np.int32))
          for k, v in tb.items()}
    V = jcfg.llm.vocab_size
    return dict(jcfg=jcfg, params=params, tcfg=tcfg, tparams=tparams, jb=jb, tb=tb,
                jcodec=JCodec(vocab_size=V), tcodec=TCodec(vocab_size=V))


def test_vla_loss_adds_the_router_losses_like_jax(moe_vlm):
    """vla_loss_fn: the loss with the router losses, metrics["loss"] the
    cross entropy, moe_aux and moe_z reported, all equal to JAX's."""
    v = moe_vlm
    jl, jm = jax.jit(lambda p, b: jstep.vla_loss_fn(p, v["jcfg"], b, v["jcodec"]))(
        v["params"], v["jb"])
    tl, tm = tstep.vla_loss_fn(v["tparams"], v["tcfg"], v["tb"], v["tcodec"])
    for k in ("loss", "moe_aux", "moe_z", "action_accuracy", "l1_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    c = v["tcfg"].llm
    want = float(tm["loss"]) + c.moe_aux_coef * float(tm["moe_aux"]) + c.moe_z_coef * float(tm["moe_z"])
    assert float(tl) == pytest.approx(want, rel=1e-6) and float(tl) > float(tm["loss"])
    assert not tm["moe_aux"].requires_grad


def _opt_config(**kw):
    return dict(learning_rate=LR, lr_schedule_type="constant", max_steps=10, weight_decay=0.01,
                **kw)


def test_two_full_finetune_steps_match_jax(moe_vlm):
    """make_train_step over the whole float tree (router and expert stacks
    included) on both sides, two AdamW steps: losses, router losses, every
    parameter after the steps."""
    v = moe_vlm
    jopt = jstate.make_optimizer(jstate.OptimizerConfig(**_opt_config()), v["params"])
    jfn = jstep.make_train_step(v["jcfg"], jopt, codec=v["jcodec"], donate=False)
    js = jstate.TrainState.create(v["params"], jopt)
    topt = tstate.make_optimizer(tstate.OptimizerConfig(**_opt_config()), v["tparams"])
    tfn = tstep.make_train_step(v["tcfg"], topt, codec=v["tcodec"])
    ts = tstate.TrainState.create(v["tparams"], topt)
    for i in range(2):
        js, jm = jfn(js, v["jb"])
        ts, tm = tfn(ts, v["tb"])
        for k in ("loss", "moe_aux", "moe_z"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=(i, k))
    want = dict(_flat(jax.tree.map(np.asarray, js.params)))
    got = dict(_flat(ts.params))
    assert set(want) == set(got)
    deltas = np.concatenate([np.abs(_np(got[k]) - want[k]).ravel() for k in want])
    for k in ("llm/layers/router", "llm/layers/gate_proj", "llm/layers/down_proj"):
        assert (got[k] - _at(v["tparams"], k)).abs().max() > LR / 2, k   # trained
    assert deltas.max() <= 2 * 2 * LR and np.quantile(deltas, 0.99) <= 1e-2 * LR


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def qlora(moe_vlm):
    """The trainer's setting over the tiny MoE VLM: int8 trunk (w8a8 STE
    route), remat, streamed LoRA r = 4 on every linear, B random."""
    v = moe_vlm
    cfg = bf.train_config(v["tcfg"], "int8")
    base = bf.base_params(cfg, "int8", torch.Generator().manual_seed(1), "cpu")
    lcfg = tlora.LoRAConfig(r=4)
    lora = tlora.init_lora_params(base, lcfg, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)

    def rand_b(t):
        if isinstance(t, dict) and set(t) == {"A", "B"}:
            return {"A": t["A"], "B": torch.randn(t["B"].shape, generator=g) * 0.02}
        return t if not isinstance(t, dict) else {k: rand_b(x) for k, x in t.items()}

    loss_fn = tlora.make_lora_loss_fn(functools.partial(tstep.vla_loss_fn, codec=v["tcodec"]),
                                      base, lcfg, stream=True)
    return dict(cfg=cfg, base=base, lora=rand_b(lora), loss_fn=loss_fn)


def test_remat_gives_the_same_grads(qlora):
    """remat on (the trainer's setting) and off: equal losses, router losses
    and gradients, bit for bit (the aux appended inside each checkpointed
    layer carries its gradient; the recompute appends nothing)."""
    q = qlora
    off = dataclasses.replace(
        q["cfg"], llm=dataclasses.replace(q["cfg"].llm, remat=False),
        vision=tuple(dataclasses.replace(c, remat=False) for c in q["cfg"].vision))
    assert q["cfg"].llm.remat
    (l_on, m_on), g_on = tstep.value_and_grad(q["loss_fn"], q["lora"], q["cfg"], bf.synthetic_batch(
        q["cfg"], 2, 12, 4, "cpu"))
    (l_off, m_off), g_off = tstep.value_and_grad(q["loss_fn"], q["lora"], off, bf.synthetic_batch(
        q["cfg"], 2, 12, 4, "cpu"))
    assert torch.equal(l_on, l_off) and torch.equal(m_on["moe_aux"], m_off["moe_aux"])
    leaves = list(zip(tstate.tree_leaves(g_on), tstate.tree_leaves(g_off)))
    assert len(leaves) > 20
    for a, b in leaves:
        assert torch.equal(a, b)
    router_in = g_on["llm"]["layers"]["gate_proj"]["A"]
    assert router_in.abs().max() > 0


def test_streamed_lora_steps_descend(qlora):
    """Four streamed-LoRA steps (make_train_step, AdamW): the loss descends,
    the expert stacks' adapters receive gradient and move, the router is not
    adapted and the base stays bit-unchanged."""
    q = qlora
    lp = q["lora"]["llm"]["layers"]
    assert lp["router"] is None
    L, E_, F_, D = q["base"]["llm"]["layers"]["gate_proj"]["q"].shape
    assert lp["gate_proj"]["A"].shape == (L, E_, 4, D) and lp["gate_proj"]["B"].shape == (L, E_, F_, 4)
    assert lp["down_proj"]["A"].shape == (L, E_, 4, F_)
    frozen = [t.clone() for t in tstate.tree_leaves(q["base"])]
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**_opt_config()), q["lora"])
    step = tstep.make_train_step(q["cfg"], opt, loss_fn=q["loss_fn"])
    state = tstate.TrainState.create(q["lora"], opt)
    batch = bf.synthetic_batch(q["cfg"], 2, 12, 5, "cpu")
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        assert bool(torch.isfinite(m["moe_aux"])) and bool(torch.isfinite(m["moe_z"]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    for k in ("gate_proj", "up_proj", "down_proj"):
        for n in "AB":
            assert not torch.equal(state.params["llm"]["layers"][k][n], lp[k][n]), (k, n)
    assert all(torch.equal(a, b) for a, b in zip(tstate.tree_leaves(q["base"]), frozen))


@pytest.mark.parametrize("aux", ["z_only", "both"])
def test_grad_accum(moe_vlm, qlora, aux):
    """grad_accum_steps=2 over 4 rows. With the load-balance term off (the z
    loss is a mean over tokens, linear in them): the same update as the full
    batch. With both terms on (E · Σ f_e P_e is not linear in the tokens):
    the same update as JAX's accumulation over the same micro-batches."""
    v, q = moe_vlm, qlora
    batch = bf.synthetic_batch(q["cfg"], 4, 12, 6, "cpu")
    if aux == "z_only":
        cfg = dataclasses.replace(q["cfg"], llm=dataclasses.replace(q["cfg"].llm,
                                                                    moe_aux_coef=0.0))
        opt = tstate.make_optimizer(tstate.OptimizerConfig(**_opt_config()), q["lora"])
        states = []
        for n in (1, 2):
            step = tstep.make_train_step(cfg, opt, loss_fn=q["loss_fn"], grad_accum_steps=n)
            states.append(step(tstate.TrainState.create(q["lora"], opt), batch))
        (s1, m1), (s2, m2) = states
        assert float(m2["moe_z"]) > 0
        np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
        deltas = np.concatenate([np.abs(_np(a) - _np(b)).ravel() for a, b in
                                 zip(tstate.tree_leaves(s2.params), tstate.tree_leaves(s1.params))])
        assert deltas.max() <= 2 * LR and np.quantile(deltas, 0.99) <= 1e-2 * LR
        return
    # both: a float trunk on both sides, full fine-tuning of the LLM only
    jb = {k: jnp.asarray(t.numpy().astype(np.float32 if k == "pixel_values" else np.int32))
          for k, t in batch.items()}
    jp, tp = v["params"]["llm"], v["tparams"]["llm"]

    def jloss(p, cfg, b):
        return jstep.vla_loss_fn({**v["params"], "llm": p}, cfg, b, v["jcodec"])

    def tloss(p, cfg, b):
        return tstep.vla_loss_fn({**v["tparams"], "llm": p}, cfg, b, v["tcodec"])

    jopt = jstate.make_optimizer(jstate.OptimizerConfig(**_opt_config()), jp)
    js, jm = jstep.make_train_step(v["jcfg"], jopt, loss_fn=jloss, donate=False,
                                   grad_accum_steps=2)(jstate.TrainState.create(jp, jopt), jb)
    topt = tstate.make_optimizer(tstate.OptimizerConfig(**_opt_config()), tp)
    ts, tm = tstep.make_train_step(v["tcfg"], topt, loss_fn=tloss, grad_accum_steps=2)(
        tstate.TrainState.create(tp, topt), batch)
    for k in ("loss", "moe_aux", "moe_z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = dict(_flat(jax.tree.map(np.asarray, js.params)))
    deltas = np.concatenate([np.abs(_np(t) - want[k]).ravel() for k, t in _flat(ts.params)])
    assert deltas.max() <= 2 * LR and np.quantile(deltas, 0.99) <= 1e-2 * LR


# --- the LoRA targets -------------------------------------------------------------------


def _targets(tree, prefix=""):
    """(path, A's shape, B's shape) at each adapter of a LoRA tree (either package's)."""
    if tree is None:
        return set()
    if set(tree) == {"A", "B"}:
        return {(prefix, tuple(np.shape(tree["A"])), tuple(np.shape(tree["B"])))}
    return set().union(*(_targets(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()))


@pytest.mark.parametrize("llm", ["llama", "mixtral", "phi"])
def test_init_lora_params_targets_the_jax_leaves(llm):
    """init_lora_params adapts the same leaves, at the same shapes, as the
    JAX package's on tiny Llama, Mixtral (the expert stacks, not the router)
    and Phi (q_w, k_w, v_w, dense_w, fc1_w, fc2_w) VLMs, over the float tree
    and over the int8 trunk."""
    jllm = {"llama": jllama.LlamaConfig.tiny(), "phi": jphi.PhiConfig.tiny(),
            "mixtral": jllama.LlamaConfig.tiny(moe_experts=4)}[llm]
    jcfg = jvlm.VLMConfig.tiny(llm=jllm)
    want = _targets(jax.eval_shape(lambda k: jlora.init_lora_params(
        jvlm.init_params(jcfg, k), jlora.LoRAConfig(r=4), k), jax.random.key(0)))
    tcfg = convert.config_from_jax(jcfg)
    tparams = convert.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = _targets(tlora.init_lora_params(tparams, tlora.LoRAConfig(r=4),
                                          torch.Generator().manual_seed(1)))
    assert got == want
    layers = {p.split("/")[2] for p, _, _ in got if p.startswith("llm/layers/")}
    assert layers == ({"q_w", "k_w", "v_w", "dense_w", "fc1_w", "fc2_w"} if llm == "phi" else
                      {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                       "down_proj"})
    if llm != "phi":   # over the int8 trunk too (the QLoRA base)
        qt = tlora.init_lora_params(bf.base_params(bf.train_config(tcfg, "int8"), "int8",
                                                   torch.Generator().manual_seed(0), "cpu"),
                                    tlora.LoRAConfig(r=4), torch.Generator().manual_seed(1))
        assert _targets(qt) == want
