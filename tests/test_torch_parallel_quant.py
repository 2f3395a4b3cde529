"""Sharded serving over quantized weights on the CPU (int8, grouped int4 and
mix, the JAX package's tests/test_sharded_serving.py trees: the trunk
quantized, group size 16) at dp = 4 x tp = 2, each rank a gloo process,
against the JAX package's `make_sharded_predict` on the same mesh and the
port's one-process run; and the row-parallel int8 product itself.

The port's route is the JAX package's default one for these leaves (no
kernel gate: `_w8a8_dot`, the grouped / requant int4 dots): the "w8a8"
route without the fused norm. Every linear quantizes its activations, so
token equality is margin-limited (the repo's rule,
tests/test_torch_turbo_kv8.py::assert_tokens): each row up to its first
token whose JAX margin is below twice the gap between the port's and the
JAX package's first logits. Each test states the count compared at its
seed. The row-parallel int8 product of the port (int32 partials, their
int32 sum, then the epilogue) is bit-equal to the one-process
`_w8a8_dot` function."""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import linear as lin
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp
from test_torch_parallel_serving import (inputs, jax_call, jax_np, jax_setup, port_call,
                                         port_config, sharded, to_port)

MESH = {"dp": 4, "fsdp": 1, "tp": 2}


@pytest.mark.parametrize("bits,group_size,n_tokens", [(8, None, 15), (4, 16, 20),
                                                      ("mix", 16, 20)])
def test_sharded_quantized_tokens(bits, group_size, n_tokens):
    from openvla_probe_tpu.ops.linear import quantize_params
    from test_torch_turbo_kv8 import assert_tokens

    jserving, jparams = jax_setup()
    kw = {} if group_size is None else {"group_size": group_size}
    jq = {**jparams, "llm": quantize_params(jparams["llm"], bits=bits, **kw)}
    params = to_port(jax_np(jq))
    serving = port_config(jserving, int8_route=True)
    args = inputs()
    want = jax_call(jq, jserving, args, return_first_logits=True)
    one = port_call(params, serving, args, return_first_logits=True)
    gap = float(np.abs(one["first_logits"] - want["first_logits"]).max())
    got = sharded(params, serving, args, MESH, "tp")
    jsh = jax_call(jq, jserving, args, MESH, "tp")
    margins = want["logit_margins"]
    for other in (want["action_tokens"], jsh["action_tokens"], one["action_tokens"]):
        assert assert_tokens(got["action_tokens"], other, margins, gap) == n_tokens
    # the quantized leaves are placed: the trunk's q_proj codes split over tp
    local = tsharding.place_params(params, tmesh.Mesh(MESH, rank=1), "tp")
    assert tp.tp_role(local["llm"]["layers"]["q_proj"]) == "col"
    assert tp.tp_role(local["llm"]["layers"]["o_proj"]) == "row"


def _gather_rank(rank, world, params, serving, args):
    """One tp rank's sharded call: the bytes it sent for whole-leaf gathers."""
    from openvla_probe_tpu_torch.models import vla as tvla
    from test_torch_parallel_serving import img_cfg, timage

    call, local = tvla.make_sharded_predict(params, serving, tmesh.make_mesh({"tp": world}),
                                            image_cfg=img_cfg(timage), strategy="tp",
                                            device="cpu")
    D.reset_collective_counts()
    call(local, *args)
    return D.COLLECTIVE_BYTES[tp.WHOLE_LEAF]


@pytest.mark.parametrize("bits", [4, "mix"])
def test_whole_leaf_gathers_match_the_tool(bits):
    """``tools/tp_gather_bytes`` counts what the forward gathers whole: at
    tp = 2 each rank sends its shards and receives the other's, so each
    rank's WHOLE_LEAF bytes equal the tool's count over its placed tree
    (grouped int4: o_proj and down_proj at prefill and at every decode step;
    mix: at decode only, prefill taking the exact int8 route); none on turbo's
    int8 leaves."""
    from openvla_probe_tpu.ops.linear import quantize_params
    from openvla_probe_tpu_torch.tools import tp_gather_bytes

    jserving, jparams = jax_setup()
    for b, want_some in ((bits, True), (8, False)):
        jq = {**jparams, "llm": quantize_params(jparams["llm"], bits=b,
                                                **({} if b == 8 else {"group_size": 16}))}
        params = to_port(jax_np(jq))
        serving = port_config(jserving, int8_route=True)
        args = inputs()
        local = tsharding.place_params(params, tmesh.Mesh({"tp": 2}, rank=0), "tp")
        want = tp_gather_bytes.gather_bytes(serving, local, batch=len(args[0]))
        assert want["towers"] == 0 and (want["trunk"] > 0) == want_some, want
        got = D.run_ranks(_gather_rank, 2, (params, serving, args), timeout=120, device="cpu")
        assert got == [want["trunk"]] * 2, (got, want)


def _row_rank(rank, world, x, w, k_pad_expected):
    """One rank's row-parallel product of a placed int8 leaf (its K slice)."""
    mesh = tmesh.make_mesh({"tp": world})
    spec = tsharding.shard_params({"o_proj": w}, mesh, "tp", "llm/layers")["o_proj"]
    leaf = tsharding.place_leaf("llm/layers/o_proj", w, spec, mesh)
    assert tp.tp_role(leaf) == "row"
    assert leaf["local"]["q"].shape[-1] == k_pad_expected
    D.reset_collective_counts()
    out = tp.matmul(x, leaf, "w8a8")
    return out, dict(D.COLLECTIVE_CALLS)


@pytest.mark.parametrize("M,K,N,dtype", [(37, 4096, 64, torch.bfloat16),
                                         (5, 4304, 48, torch.bfloat16),
                                         (9, 2048, 32, torch.float32)])
def test_row_parallel_int8_bit_equal(M, K, N, dtype):
    """The row-parallel product at tp = 2 (K = 4304 splits into 2152, padded
    to 2160 with zero codes at placement): every rank's output bit-equal to
    the one-process w8a8 product; one MAX and one SUM all-reduce."""
    g = torch.Generator().manual_seed(M)
    x = (torch.randn(M, K, generator=g) * 3).to(dtype)
    w = lin.quantize_weight(torch.randn(N, K, generator=g))
    want = lin.w8a8_matmul_plain(x, w)
    k_loc = K // 2
    res = D.run_ranks(_row_rank, 2, (x, w, -(-k_loc // 16) * 16), timeout=120, device="cpu")
    for out, calls in res:
        assert torch.equal(out, want)
        assert calls == {"all_reduce": 2}


def test_quant_given_and_epilogue_compose_to_w8a8():
    """The three plain steps over the whole K give `w8a8_matmul_plain`'s
    output bit for bit (one rank's view), the padded columns zero codes."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(11, 200, generator=g).to(torch.bfloat16)
    w = lin.quantize_weight(torch.randn(24, 200, generator=g))
    sx = torch.clamp(lin.div127(x.abs().amax(-1, keepdim=True).float()), min=1e-8)
    codes = lin.w8a8_quant_given(x, sx, 208)
    assert codes.shape == (11, 208) and not codes[:, 200:].any()
    wp = {"q": torch.nn.functional.pad(w["q"], (0, 8)), "s": w["s"]}
    acc = lin.w8a8_matmul_i32(codes, wp)
    assert acc.dtype == torch.int32
    out = lin.w8a8_epilogue(acc, sx, w["s"], x.dtype)
    assert torch.equal(out, lin.w8a8_matmul_plain(x, w))
    nib = lin.quantize_weight_nibble(torch.randn(24, 224, generator=g))
    x2 = torch.randn(40, 224, generator=g)
    sx2 = torch.clamp(lin.div127(x2.abs().amax(-1, keepdim=True)), min=1e-8)
    acc2 = lin.w8a8_matmul_i32(lin.w8a8_quant_given(x2, sx2, 224, nibble=True), nib)
    assert torch.equal(lin.w8a8_epilogue(acc2, sx2, nib["s"], x2.dtype),
                       lin.w8a8_matmul_plain(x2, nib))


@pytest.mark.parametrize("rows,row_split,decode", [(8, 4, True), (8, 5, False), (33, 1, False),
                                                   (32, 1, True)])
def test_row_split_reads_the_whole_batch_rows(rows, row_split, decode):
    """A mix leaf's copy is picked by the whole batch's rows, x's rows times
    `row_split` (the ranks on dp): the int4 copy at M <= 32 (decode), the
    int8 copy above, whatever one rank's share of the rows."""
    g = torch.Generator().manual_seed(rows * row_split)
    w = lin.quantize_weight_mixed(torch.randn(24, 64, generator=g), 16)
    x = torch.randn(rows, 64, generator=g)
    want = (lin.w4a8_grouped_plain(x, w["q4"], w["s4"]) if decode
            else lin.w8a8_matmul_plain(x, lin.int8_copy(w)))
    assert torch.equal(lin.matmul_t(x, w, "w8a8", row_split), want)
    assert torch.equal(tp.matmul(x, w, "w8a8", row_split), want)
