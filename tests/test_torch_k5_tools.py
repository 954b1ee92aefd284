"""The readers of K5's build log and SASS that the K5 loop and chip_smoke.py
rely on (scripts/bench_k5_torch.py ``ptxas``, scripts/sass_k5_torch.py
``functions`` and ``loops``), on small texts in the tools' formats."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BUILD_LOG = """traj_packed.cu: 52.3 s
==== traj_packed.cu
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__x_14_traj_packed_cu_e86b578f18traj_packed_kernelILi12ELi2ELb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__x_14_traj_packed_cu_e86b578f18traj_packed_kernelILi12ELi2ELb0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__x_14_traj_packed_cu_e86b578f18traj_packed_kernelILi32ELb1EEEvNS_4ArgsE' for 'sm_90a'
    8048 bytes stack frame, 56988 bytes spill stores, 70048 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 8048 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z16other_kernelv' for 'sm_90a'
ptxas info    : Used 40 registers
"""


@pytest.mark.parametrize("ix,want", [
    (0, {"km": 12, "cc": 2, "depth": 0, "registers": 168, "spill_stores": 0, "spill_loads": 0}),
    (1, {"km": 32, "cc": 1, "depth": 1, "registers": 32, "spill_stores": 56988, "spill_loads": 70048}),
])
def test_ptxas_reads_each_k5_instantiation(tmp_path, ix, want):
    """<KM, CC, DEEP> names and the <KM, DEEP> names of earlier checkouts (CC
    1), with their registers and spills; other kernels are left out."""
    log = tmp_path / "build.log"
    log.write_text(BUILD_LOG)
    found = _load("bench_k5_torch").ptxas(log)
    assert len(found) == 2
    assert found[ix] == want


BUILD_LOG_KM_CC = """traj_packed.cu: 48.0 s
==== traj_packed.cu
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__x_14_traj_packed_cu_e86b578f18traj_packed_kernelILi16ELi2EEEvNS_4ArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__x_14_traj_packed_cu_e86b578f16traj_deep_kernelILi64EEEvNS_8DeepArgsE' for 'sm_90a'
    40 bytes stack frame, 56 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 40 bytes cumulative stack size
"""


def test_ptxas_reads_the_depth0_kernels_km_cc_names(tmp_path):
    """<KM, CC> names (the depth-0 design, no depth parameter since the deep
    design went to traj_deep_kernel) read as depth 0; the deep kernel is
    left out."""
    log = tmp_path / "build.log"
    log.write_text(BUILD_LOG_KM_CC)
    assert _load("bench_k5_torch").ptxas(log) == [
        {"km": 16, "cc": 2, "depth": 0, "registers": 168, "spill_stores": 0, "spill_loads": 0}]


SASS = """
        Function : _ZN12_GLOBAL__N_118traj_packed_kernelILi12ELi2ELb0EEEvNS_4ArgsE
    .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R8, R4, R5, R8 ;
        /*0030*/                   FFMA R9, R4, R6, R9 ;
        /*0040*/                   I2F R10, R11 ;
        /*0050*/                   STL [R1], R10 ;
        /*0060*/                   ISETP.NE.AND P0, PT, R12, RZ, PT ;
        /*0070*/              @P0 BRA `(.L_x_0) ;
        /*0080*/                   BRA 0x30 ;
        /*0090*/                   EXIT ;
"""


def test_sass_finds_the_backward_branches():
    """A labelled backward branch and a hex one are loops; the body's
    instructions are counted by kind."""
    S = _load("sass_k5_torch")
    funcs, label_at = S.functions(SASS)
    (name, ins), = funcs.items()
    assert "traj_packed_kernelILi12ELi2ELb0E" in name
    assert [op for _, op, _ in ins][:3] == ["MOV", "LDS.128", "FFMA"]
    assert sorted(S.loops(name, ins, label_at)) == [(0x10, 0x70), (0x30, 0x80)]
    body = [op for a, op, _ in ins if 0x10 <= a <= 0x70]
    assert sum(op.startswith("FFMA") for op in body) == 2
    assert sum(op.startswith(("LDL", "STL")) for op in body) == 1
