"""The port's process-group helpers (``openvla_probe_tpu_torch/parallel/distributed.py``):
the backend rule, the single-process no-ops, rank 0 as the one file writer
(the training checkpoints and the dataset statistics read it from here),
the collectives' counters, and `run_ranks`, which fails a run when a rank
raises, exits without a result or outlives its timeout."""

import os
import time

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 8, 4, "gloo")])
def test_backend_rule(device, world, cards, want):
    assert D.backend_rule(device, world, cards) == want


def test_single_process_no_ops(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert D.initialize_distributed() is None
    assert D.is_primary() and D.process_count() == 1
    D.barrier()
    np.testing.assert_array_equal(D.broadcast_host_value(np.arange(3)), np.arange(3))
    t = torch.ones(3)
    assert D.all_reduce(t, "sum", None) is t
    assert D.all_gather(t, 0, None) is t


def test_no_cpu_fallback_for_cuda_ranks(monkeypatch):
    """Ranks asked to run on cards where there is none raise; nothing falls
    back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.initialize_distributed()


def test_one_primary_writer():
    from openvla_probe_tpu_torch.training import checkpointing
    from openvla_probe_tpu_torch.vla import norm_stats

    assert checkpointing.is_primary is D.is_primary
    assert "is_primary" in open(norm_stats.__file__).read()


def _helpers(rank, world):
    mesh = tmesh.make_mesh({"dp": 2, "tp": world // 2})
    D.reset_collective_counts()
    t = torch.full((3,), float(rank + 1))
    D.all_reduce(t, "sum", mesh.group("tp"))
    m = torch.tensor([float(rank)])
    D.all_reduce(m, "max", None if world == 1 else torch.distributed.group.WORLD)
    gathered = D.all_gather(torch.tensor([rank]), 0, mesh.group("dp"))
    D.barrier()
    return dict(primary=D.is_primary(), count=D.process_count(),
                seed=D.broadcast_host_value(np.array([rank + 5])).tolist(),
                tp_sum=t.tolist(), max=m.item(), dp=gathered.tolist(), coords=mesh.coords,
                calls=dict(D.COLLECTIVE_CALLS), bytes=dict(D.COLLECTIVE_BYTES))


def test_ranks_share_a_group():
    res = D.run_ranks(_helpers, 4, timeout=120, device="cpu")
    assert [r["primary"] for r in res] == [True, False, False, False]
    for rank, r in enumerate(res):
        assert r["count"] == 4 and r["seed"] == [5] and r["max"] == 3.0
        assert r["coords"] == {"dp": rank // 2, "tp": rank % 2}
        # tp groups {0, 1} and {2, 3}; dp groups {0, 2} and {1, 3}
        lo = 2 * (rank // 2)
        assert r["tp_sum"] == [float(lo + 1 + lo + 2)] * 3
        assert r["dp"] == [rank % 2, rank % 2 + 2]
        assert r["calls"] == {"all_reduce": 2, "all_gather": 1}
        assert r["bytes"] == {"all_reduce": 12 + 4, "all_gather": 8}


def _raises(rank, world):
    D.barrier()   # every rank through the rendezvous before one fails
    if rank == 1:
        raise ValueError("rank one's fault")
    return rank


def _exits(rank, world):
    D.barrier()
    if rank == 0:
        os._exit(3)
    return rank


def _hangs(rank, world):
    time.sleep(600)


@pytest.mark.parametrize("fn,match,timeout", [
    (_raises, "rank 1 failed:(.|\n)*rank one's fault", 120),
    (_exits, "rank 0 exited with code 3 and no result", 120),
    (_hangs, r"ranks \[0, 1\] still running after 10.0 s", 10.0)])
def test_run_ranks_fails_on_a_rank(fn, match, timeout):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        D.run_ranks(fn, 2, timeout=timeout, device="cpu")
    assert time.monotonic() - t0 < timeout + 60


def test_kernel_layer_imports_nothing_of_parallel():
    """``ops/`` (the kernels' wrappers and route rules) imports nothing of
    ``parallel/``: the models take placed leaves through
    ``tensor_parallel.matmul`` / ``index_layer``, and a data-parallel rank's
    row count reaches the route rules as an argument (``row_split``)."""
    import ast
    from pathlib import Path

    import openvla_probe_tpu_torch.ops as ops

    for path in sorted(Path(ops.__file__).parent.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any("parallel" in n.split(".") for n in names), (path.name, names)
