"""The sharded train step's differentiable pieces on the CPU
(``parallel.distributed``'s autograd collectives, the row-parallel int8 STE
of ``parallel.tensor_parallel``), and the row-parallel product at a local
contraction that is not a multiple of 4.

* Each autograd collective's backward is the transpose of its forward, on
  two gloo ranks: `reduce_from` (a SUM whose result every rank uses as its
  own) hands every rank the cotangent; `copy_to` SUM-reduces the ranks'
  cotangents; `all_gather` reduce-scatters them (``"reduce_scatter"``) or
  hands each rank its slice of the one cotangent (``"split"``). The
  adjoint identity <f(x), y> = <x, fᵀ(y)> holds over the group, and the
  backward's collectives count under their own tags.
* `_RowExactSTE` on two threads whose all-reduces meet at a barrier (as
  tests/test_torch_row_parallel.py runs the chain): each rank's output is
  the one-card ``_w8a8_dot``'s, bit for bit, and its dx is bit-equal to the
  rank's K slice of the one-process STE dx (`_int8_ste_dx`), in bf16 at
  SigLIP fc2's 4304 (2152 a rank, the codes padded to 2160) and in fp32.
* A local K of 538 (SigLIP fc2 at tp = 8; K = 1076 at tp = 2 here): the
  activation columns reaching `w8a8_row_absmax` and `w8a8_quant_given` are
  zero-padded to 540, and the output stays bit-equal to
  `w8a8_matmul_plain` over the unpadded weight.
"""

import threading

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import linear as lin
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp

RANKS = 2


def place_row(leaf: dict, rank: int, tp_size: int = 2) -> dict:
    """An int8 leaf [N, K] placed as a row-parallel o_proj on rank `rank`
    (the real placement: K split, the local codes zero-padded to 16)."""
    mesh = tmesh.Mesh({"tp": tp_size}, rank=rank)
    spec = tsharding.shard_params({"o_proj": leaf}, mesh, "tp", "llm/layers")["o_proj"]
    placed = tsharding.place_leaf("llm/layers/o_proj", leaf, spec, mesh)
    assert tp.tp_role(placed) == "row"
    return placed


# --- the collectives' transposes on two gloo ranks ---------------------------------------


def _rand(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)


def rank_transposes(rank, world):
    """For each collective: (forward output, backward input gradient, the
    rank's input and cotangent, the counters of its backward)."""
    import torch.distributed as dist

    g = dist.new_group(list(range(world)))
    out = {}
    cases = {
        # (input, same on every rank?, cotangent, same on every rank?)
        "reduce_from": (_rand(rank, 3, 5), _rand(100, 3, 5)),
        "copy_to": (_rand(7, 3, 5), _rand(200 + rank, 3, 5)),
        "gather_rs": (_rand(rank, 3, 5), _rand(300 + rank, 3, 5 * world)),
        "gather_split": (_rand(rank, 3, 5), _rand(400, 3, 5 * world)),
    }
    for name, (x, ybar) in cases.items():
        x = x.clone().requires_grad_(True)
        D.reset_collective_counts()
        if name == "reduce_from":
            y = D.reduce_from(x, g)
        elif name == "copy_to":
            y = D.copy_to(x, g)
        else:
            y = D.all_gather(x, 1, g, backward="reduce_scatter" if name == "gather_rs" else "split")
        fwd = dict(D.COLLECTIVE_CALLS)
        D.reset_collective_counts()
        y.backward(ybar)
        out[name] = dict(x=x.detach(), y=y.detach(), ybar=ybar, xbar=x.grad, fwd=fwd,
                         bwd=dict(D.COLLECTIVE_CALLS))
    return out


@pytest.fixture(scope="module")
def transposes():
    return D.run_ranks(rank_transposes, RANKS, timeout=120, device="cpu")


def _dot(a, b):
    return float((a * b).sum())


def test_reduce_from_backward_is_the_identity(transposes):
    """Y = Σ_r x_r, used by every rank as its own: x̄_r = ȳ, no collective;
    <Y, ȳ> = Σ_r <x_r, x̄_r>."""
    ranks = [r["reduce_from"] for r in transposes]
    want = sum(r["x"] for r in ranks)
    for r in ranks:
        assert torch.equal(r["y"], want) and torch.equal(r["xbar"], r["ybar"])
        assert r["fwd"] == {"all_reduce": 1} and r["bwd"] == {}
    assert _dot(want, ranks[0]["ybar"]) == pytest.approx(sum(_dot(r["x"], r["xbar"])
                                                             for r in ranks), rel=1e-12)


def test_copy_to_backward_sums_the_cotangents(transposes):
    """y_r = x on every rank: x̄ = Σ_r ȳ_r on every rank (SUM all-reduce,
    tag all_reduce_bwd); Σ_r <x, ȳ_r> = <x, x̄>."""
    ranks = [r["copy_to"] for r in transposes]
    want = sum(r["ybar"] for r in ranks)
    for r in ranks:
        assert torch.equal(r["y"], r["x"])
        # the sum runs in fp32 (fp64 inputs here): within fp32 rounding
        torch.testing.assert_close(r["xbar"], want, rtol=1e-6, atol=1e-6)
        assert r["fwd"] == {} and r["bwd"] == {"all_reduce_bwd": 1}
    assert sum(_dot(ranks[0]["x"], r["ybar"]) for r in ranks) == pytest.approx(
        _dot(ranks[0]["x"], ranks[0]["xbar"]), rel=1e-6)


def test_all_gather_backward_reduce_scatters(transposes):
    """X = [x_0 | x_1] on every rank, the ranks' uses terms of one sum:
    x̄_r = (Σ_s ȳ_s)[r's slice] (tag all_reduce_slice_bwd: an all-reduce, then the slice); Σ_r <X, ȳ_r> =
    Σ_r <x_r, x̄_r>."""
    ranks = [r["gather_rs"] for r in transposes]
    X = torch.cat([r["x"] for r in ranks], dim=1)
    total = sum(r["ybar"] for r in ranks)
    for i, r in enumerate(ranks):
        assert torch.equal(r["y"], X)
        assert torch.equal(r["xbar"], total[:, 5 * i:5 * (i + 1)])
        assert r["fwd"] == {"all_gather": 1} and r["bwd"] == {"all_reduce_slice_bwd": 1}
    assert sum(_dot(X, r["ybar"]) for r in ranks) == pytest.approx(
        sum(_dot(r["x"], r["xbar"]) for r in ranks), rel=1e-12)


def test_all_gather_split_backward_hands_each_rank_its_slice(transposes):
    """X = [x_0 | x_1], one tensor every rank computes with: x̄_r = ȳ[r's
    slice], no collective; <X, ȳ> = Σ_r <x_r, x̄_r>."""
    ranks = [r["gather_split"] for r in transposes]
    X = torch.cat([r["x"] for r in ranks], dim=1)
    for i, r in enumerate(ranks):
        assert torch.equal(r["y"], X)
        assert torch.equal(r["xbar"], r["ybar"][:, 5 * i:5 * (i + 1)])
        assert r["fwd"] == {"all_gather": 1} and r["bwd"] == {}
    assert _dot(X, ranks[0]["ybar"]) == pytest.approx(sum(_dot(r["x"], r["xbar"])
                                                          for r in ranks), rel=1e-12)


def test_collectives_without_grad_are_the_serving_calls(monkeypatch):
    """Without autograd the differentiable forms are today's calls: in
    place, counted under the same tags (a group of one here: no call)."""
    x = torch.randn(3, 4, requires_grad=True)
    with torch.no_grad():
        assert D.reduce_from(x, None) is x and D.copy_to(x, None) is x
    calls = []
    monkeypatch.setattr(D, "all_reduce", lambda t, op, group, tag="all_reduce":
                        calls.append((op, tag)) or t)
    y = torch.randn(3, 4)
    assert D.reduce_from(y, "g") is y and calls == [("sum", "all_reduce")]
    assert D.copy_to(y, "g") is y


# --- the row-parallel STE on two threads -------------------------------------------------


class _Threads:
    """`_row_exact`'s two ranks as two threads, their all-reduces met at a
    barrier (no process group), as tests/test_torch_row_parallel.py runs
    the chain."""

    def __init__(self, monkeypatch, tp_size=2):
        self.barrier = threading.Barrier(tp_size, timeout=60)
        self.posted = {}
        self.tp_size = tp_size
        monkeypatch.setattr(D, "all_reduce", self.all_reduce)
        monkeypatch.setattr(tp, "tp_coord", lambda w: (w["mesh"].coord("tp"), tp_size,
                                                       w["mesh"].coord("tp")))

    def all_reduce(self, t, op, rank, tag="all_reduce"):
        self.posted[(op, rank)] = t.clone()
        self.barrier.wait()
        parts = [self.posted[(op, r)] for r in range(self.tp_size)]
        red = torch.stack(parts).amax(0) if op == "max" else sum(parts)
        self.barrier.wait()
        return t.copy_(red)

    def run(self, fn):
        outs = [None] * self.tp_size
        errs = []

        def rank(r):
            try:
                outs[r] = fn(r)
            except BaseException as e:   # re-raised in the test's thread
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(self.tp_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        if errs:
            raise errs[0]
        return outs


@pytest.mark.parametrize("name", ["bf16_siglip_fc2", "fp32"])
def test_row_ste_dx_on_two_threads_equals_the_one_process_k_slices(monkeypatch, name):
    from tests.test_torch_row_parallel import _case

    th = _Threads(monkeypatch)
    xt, leaf, want, _ = _case(name)
    M, K = xt.shape
    k = K // 2
    g = torch.randn(M, leaf["q"].shape[0], generator=torch.Generator().manual_seed(3)).to(xt.dtype)
    dx_one = lin._int8_ste_dx(g, leaf["q"], leaf["s"])

    def rank(r):
        xl = xt[:, r * k:(r + 1) * k].clone().requires_grad_(True)
        y = tp.matmul(xl, place_row(leaf, r), "w8a8")
        y.backward(g)
        return y.detach(), xl.grad

    for r, (y, dx) in enumerate(th.run(rank)):
        assert torch.equal(y.float(), want)
        assert dx.dtype == xt.dtype and torch.equal(dx, dx_one[:, r * k:(r + 1) * k]), r


def test_row_steps_raise_under_grad_outside_the_ste():
    """The STE is the one differentiable way into the four kernels: each
    wrapper still raises on an input that requires grad."""
    x = torch.randn(4, 32).requires_grad_(True)
    with pytest.raises(RuntimeError, match="an input requires grad"):
        lin.w8a8_row_absmax(x)


def test_local_k_538_is_padded_to_a_multiple_of_4(monkeypatch):
    """K = 1076 at tp = 2 (538 a rank: SigLIP fc2's local width at tp = 8):
    both pre-pass steps see 540 columns, the last two zero, and the product
    is `w8a8_matmul_plain`'s over the whole unpadded weight, bit for bit."""
    th = _Threads(monkeypatch)
    rng = np.random.default_rng(9)
    M, K, N = 7, 1076, 24
    x = torch.from_numpy((rng.standard_normal((M, K)) * 2).astype(np.float32)).bfloat16()
    leaf = lin.quantize_weight(torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)))
    want = lin.w8a8_matmul_plain(x, leaf)
    seen = []
    for name in ("w8a8_row_absmax", "w8a8_quant_given"):
        real = getattr(lin, name)

        def spy(t, *a, _real=real, _name=name, **kw):
            seen.append((_name, tuple(t.shape), bool((t[:, 538:] == 0).all())))
            return _real(t, *a, **kw)

        monkeypatch.setattr(lin, name, spy)
    placed = [place_row(leaf, r) for r in range(2)]
    assert placed[0]["k_valid"] == 538 and placed[0]["local"]["q"].shape[-1] == 544
    with torch.no_grad():
        outs = th.run(lambda r: tp.matmul(x[:, 538 * r:538 * (r + 1)], placed[r], "w8a8"))
    for out in outs:
        assert torch.equal(out, want)
    assert sorted(seen) == sorted([(n, (M, 540), True) for n in ("w8a8_row_absmax",
                                                                 "w8a8_quant_given")] * 2)
