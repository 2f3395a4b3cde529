"""Reuse of built kernel libraries across processes (ops/_build.py), on the
CPU with a stub compiler: the build key is a hash of every file under
ops/csrc/, NVCC_FLAGS and ``nvcc --version``; `libraries` reuses the stored
libraries only when every stored key equals the current one, and otherwise
builds (one compiler call a source), never loading the old library; a
library that fails to load raises."""

import shutil
import sys
from pathlib import Path

import pytest

from openvla_probe_tpu_torch.ops import _build

STUB = """import os, sys
args = sys.argv[1:]
if args == ["--version"]:
    print(os.environ.get("STUB_NVCC_VERSION", "stub nvcc 1.0"))
    sys.exit(0)
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write("not a library: " + args[-1])
with open(os.environ["STUB_NVCC_LOG"], "a") as f:
    f.write(os.path.basename(args[-1]) + "\\n")
"""


@pytest.fixture
def stub(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    exe = tmp_path / "nvcc"
    exe.write_text(f"#!{sys.executable}\n" + STUB)
    exe.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("STUB_NVCC_LOG", str(log))
    monkeypatch.delenv("STUB_NVCC_VERSION", raising=False)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(exe))
    monkeypatch.setattr(_build, "build_report", {})
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_launchers", {})

    def compiles():
        n = log.read_text().split()
        log.write_text("")
        return n

    return csrc, exe, compiles


def _key(exe):
    return _build.build_key(str(exe))


def test_a_build_is_reused_under_its_key(stub):
    csrc, exe, compiles = stub
    libs = _build.libraries()
    assert sorted(compiles()) == sorted(_build.sources())      # one compiler call a source
    assert _build.build_report["reused"] is False
    for lib in libs.values():
        assert lib.read_text().startswith("not a library")
        assert lib.with_suffix(".key").read_text() == _key(exe)
    assert _build.libraries() == libs
    assert compiles() == [] and _build.build_report["reused"] is True


@pytest.mark.parametrize("change", ["header", "source", "new file", "flags", "compiler"])
def test_any_change_rebuilds(stub, monkeypatch, change):
    csrc, exe, compiles = stub
    _build.libraries()
    compiles()
    before = _key(exe)
    if change == "header":
        p = csrc / "hopper.cuh"
        p.write_text(p.read_text() + "\n// edited\n")
    elif change == "source":
        p = csrc / "w8a8_matmul.cu"
        p.write_bytes(p.read_bytes().replace(b"\n", b"\r\n", 1))
    elif change == "new file":
        (csrc / "extra.cuh").write_text("// a new header\n")
    elif change == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DOVLA_EDITED"])
    else:
        monkeypatch.setenv("STUB_NVCC_VERSION", "stub nvcc 1.1")
    assert _key(exe) != before
    libs = _build.libraries()
    assert sorted(compiles()) == sorted(_build.sources())
    assert _build.build_report["reused"] is False
    assert all(lib.with_suffix(".key").read_text() == _key(exe) for lib in libs.values())


@pytest.mark.parametrize("damage", ["stale key", "no key", "no library"])
def test_a_stored_key_that_does_not_match_builds(stub, damage):
    csrc, exe, compiles = stub
    libs = _build.libraries()
    compiles()
    lib = libs[_build.sources()[0]]
    if damage == "stale key":
        lib.with_suffix(".key").write_text("0" * 64)
    elif damage == "no key":
        lib.with_suffix(".key").unlink()
    else:
        lib.unlink()
    _build.libraries()
    assert sorted(compiles()) == sorted(_build.sources())


def test_a_library_that_fails_to_load_raises(stub):
    _build.libraries()
    with pytest.raises(OSError):
        _build.load("w8a8_matmul")
    assert _build._loaded == {}


def test_the_key_covers_every_csrc_file():
    files = {p.name for p in Path(_build.CSRC).rglob("*") if p.is_file()}
    assert {"hopper.cuh", "int8_mma.cuh", "w8a8_matmul.cu"} <= files
    assert set(_build.sources()) <= files
