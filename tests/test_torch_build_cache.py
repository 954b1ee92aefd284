"""The per-source object cache of rs_bann_tpu_torch/ops/_build.py, on the CPU.

``nvcc`` is a stand-in script that writes the file after ``-o`` (the link),
and ``compile_all`` a stand-in that writes one object per source and
records which sources it was asked to compile, both over a temporary
``csrc/`` and build directory. An unchanged tree compiles nothing, an
edited ``.cu`` recompiles itself alone, an edited ``.cuh`` every source;
``build.log`` names the compiled and the reused sources.
"""

from pathlib import Path

import pytest

from rs_bann_tpu_torch.ops import _build

SOURCES = ("a.cu", "b.cu", "c.cu")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in SOURCES + ("common.cuh",):
        (csrc / name).write_text(f"// {name}\n")
    fake_nvcc = tmp_path / "nvcc"
    fake_nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                         '  if [ "$1" = "-o" ]; then echo lib > "$2"; fi\n  shift\ndone\n')
    fake_nvcc.chmod(0o755)
    compiled = []

    def compile_all(compiler, flags, cu, tmpdir):
        compiled.append(sorted(p.name for p in cu))
        objs = [Path(tmpdir) / f"{p.stem}.o" for p in cu]
        for src, obj in zip(cu, objs):
            obj.write_bytes(src.read_bytes())
            (obj.parent / f"{src.stem}.log").write_text(f"ptxas info for {src.name}\n")
        return objs, [0] * len(cu), [0.5] * len(cu), ""

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake_nvcc))
    monkeypatch.setattr(_build, "compile_all", compile_all)
    return csrc, compiled


@pytest.mark.parametrize("edit,recompiled", [
    (None, []),
    ("b.cu", ["b.cu"]),
    ("common.cuh", list(SOURCES)),
])
def test_build_recompiles_only_what_changed(tree, edit, recompiled):
    csrc, compiled = tree
    first = _build.build()
    assert first.exists() and compiled == [list(SOURCES)]
    assert _build.build() == first and len(compiled) == 1  # the library itself is reused
    if edit is None:
        first.unlink()  # the objects alone are reused, and relinked
    else:
        (csrc / edit).write_text(f"// {edit}, edited\n")
    second = _build.build()
    assert second.exists() and (second == first) == (edit is None)
    assert compiled[1:] == ([recompiled] if recompiled else [])
    log = (_build.BUILD_DIR / "build.log").read_text()
    for name in SOURCES:
        assert (f"{name}: 0.5 s" if name in recompiled else f"{name}: reused") in log
        assert f"==== {name}\nptxas info for {name}" in log
    objects = sorted(p.name for p in (_build.BUILD_DIR / "obj").glob("*.o"))
    assert len(objects) == len(SOURCES) + len(recompiled)
