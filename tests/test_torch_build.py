"""The build cache: a library's name hashes its source, the csrc headers it
includes and the flags, so an edited header never loads a stale build."""

import importlib.util
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_both_attention_sources_include_the_tile_engine(csrc):
    for source in ("flash_attn.cu", "maclaurin_attn.cu"):
        assert build.includes(source) == [source, "attn_tile.cuh", "ptx.cuh"]
    assert build.includes("quadform.cu") == ["quadform.cu", "ptx.cuh"]


def test_b2_includes_the_tile_engine_and_the_fourier_kernels_neither(csrc):
    """B2 takes the tile engine's f32 k-step and the PTX wrappers through it;
    the fourier kernels, B4/B5 and B6/B7, take the shared cos and the PTX
    wrappers."""
    assert build.includes("rbf_pred.cu") == ["rbf_pred.cu", "attn_tile.cuh", "ptx.cuh"]
    for source in ("rff_score.cu", "fastfood.cu"):
        assert build.includes(source) == [source, "cos.cuh", "ptx.cuh"]


def test_an_edited_header_changes_the_library_path(csrc):
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    before = {s: build.library_path(s) for s in sources}
    with open(csrc / "attn_tile.cuh", "ab") as f:
        f.write(b"\n// one more line\n")
    after = {s: build.library_path(s) for s in sources}
    changed = {s for s in sources if before[s] != after[s]}
    assert changed == {"flash_attn.cu", "maclaurin_attn.cu", "rbf_pred.cu"}
    assert all(after[s].name.startswith(s.removesuffix(".cu") + "-") for s in sources)


def test_an_edited_ptx_header_rebuilds_every_tensor_core_kernel(csrc):
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    before = {s: build.library_path(s) for s in sources}
    with open(csrc / "ptx.cuh", "ab") as f:
        f.write(b"\n// one more line\n")
    changed = {s for s in sources if before[s] != build.library_path(s)}
    assert changed == {
        "fastfood.cu",
        "flash_attn.cu",
        "maclaurin_attn.cu",
        "quadform.cu",
        "rbf_pred.cu",
        "rff_score.cu",
    }


def test_an_edited_cos_header_rebuilds_both_fourier_sources(csrc):
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    before = {s: build.library_path(s) for s in sources}
    with open(csrc / "cos.cuh", "ab") as f:
        f.write(b"\n// one more line\n")
    changed = {s for s in sources if before[s] != build.library_path(s)}
    assert changed == {"fastfood.cu", "rff_score.cu"}


def test_nested_includes_are_hashed_and_a_missing_one_is_left_to_nvcc(csrc):
    (csrc / "a.cu").write_text('#include "b.cuh"\n#include <cuda_runtime.h>\n')
    (csrc / "b.cuh").write_text('#pragma once\n  #  include "c.cuh"\n#include "gone.cuh"\n')
    (csrc / "c.cuh").write_text("#pragma once\n")
    assert build.includes("a.cu") == ["a.cu", "b.cuh", "c.cuh"]
    first = build.library_path("a.cu")
    (csrc / "c.cuh").write_text("#pragma once\n// edited\n")
    assert build.library_path("a.cu") != first


def test_compiled_reads_registers_spills_and_tensor_core_opcodes():
    """chip_smoke.py reads, from cuobjdump's listings of a built library,
    what each function compiled to."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    name = "_ZN9attn_tile8attn_fwdINS_7SoftmaxELb1ELi64EEEvNS_4ArgsE"
    usage = (
        "Resource usage:\n Common:\n  GLOBAL:0\n"
        f" Function {name}:\n"
        "  REG:168 STACK:8 SHARED:0 LOCAL:4 CONSTANT[0]:592 TEXTURE:0 SURFACE:0 SAMPLER:0\n"
    )
    sass = (
        f"\t\tFunction : {name}\n"
        "        /*0a30*/   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "        /*0a40*/   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;\n"
        "        /*0a50*/   LDSM.16.MT88.4 R4, [R2] ;\n"
        "        /*0a60*/   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64], P0 ;\n"
        "        /*0a70*/   FADD R1, R2, R3 ;\n"
    )
    assert chip_smoke.read_compiled(sass, usage) == {
        name: {
            "registers": 168,
            "stack_bytes": 8,
            "local_bytes": 4,
            "sass": {"HMMA.16816.F32.BF16": 2, "LDSM.16.MT88.4": 1, "LDGSTS.E.BYPASS.128": 1},
        }
    }


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_compiled_bodies_hold_b1_and_b3_on_the_tensor_cores_without_spills(monkeypatch):
    """chip_smoke.py's ``compiled`` check of the quadform library: the f32
    (B1) and the int8 (B3) instantiation of one template must each hold a
    tensor-core MMA and no stack or local bytes."""
    chip_smoke = _load_chip_smoke()
    mma_in, simt, spill_free = chip_smoke.TENSOR_CORE_BODIES["quadform-"]
    assert (mma_in, simt, spill_free) == ("quadform_tf32", None, True)
    f32 = "_ZN12_GLOBAL__N_113quadform_tf32IfLi128EEEvPKfPKT_S2_S2_iiibPfS6_"
    q8 = "_ZN12_GLOBAL__N_113quadform_tf32IaLi128EEEvPKfPKT_S2_S2_iiibPfS6_"

    def listing(q8_op, q8_stack=0):
        sass = (
            f"\t\tFunction : {f32}\n        /*0a30*/   HMMA.1688.F32.TF32 R24, R4, R20, R24 ;\n"
            f"\t\tFunction : {q8}\n        /*0a30*/   {q8_op} R24, R4, R20, R24 ;\n"
        )
        usage = "".join(
            f" Function {n}:\n  REG:{r} STACK:{st} SHARED:0 LOCAL:0 CONSTANT[0]:592\n"
            for n, r, st in ((f32, 225, 0), (q8, 190, q8_stack))
        )

        def run(cmd, **kw):
            out = sass if "-sass" in cmd else usage
            return type("Done", (), {"stdout": out})()

        monkeypatch.setattr(chip_smoke.subprocess, "run", run)

    lib, cuobjdump = Path("quadform-x.so"), Path("cuobjdump")
    listing("HMMA.1688.F32.TF32")
    bodies = chip_smoke.compiled_bodies(lib, cuobjdump, mma_in, simt, spill_free)
    assert bodies[f32]["sass"] == {"HMMA.1688.F32.TF32": 1} and bodies[f32]["registers"] == 225
    assert bodies[q8]["sass"] == {"HMMA.1688.F32.TF32": 1} and bodies[q8]["registers"] == 190
    listing("FFMA")
    with pytest.raises(chip_smoke.PhaseFailed, match=f"{q8} holds no tensor-core MMA"):
        chip_smoke.compiled_bodies(lib, cuobjdump, mma_in, simt, spill_free)
    listing("HMMA.1688.F32.TF32", q8_stack=16)
    with pytest.raises(chip_smoke.PhaseFailed, match=f"{q8} has 16 stack/local bytes"):
        chip_smoke.compiled_bodies(lib, cuobjdump, mma_in, simt, spill_free)


def test_compiled_bodies_hold_b4_b5_on_the_tensor_cores_without_spills(monkeypatch):
    """chip_smoke.py's ``compiled`` check of the rff_score library: each
    instantiation must hold a tensor-core MMA and no stack or local bytes."""
    chip_smoke = _load_chip_smoke()
    mma_in, simt, spill_free = chip_smoke.TENSOR_CORE_BODIES["rff_score-"]
    f32 = "_ZN12_GLOBAL__N_18rff_tf32IfLi128EEEvPKf"
    q8 = "_ZN12_GLOBAL__N_18rff_tf32IaLi128EEEvPKf"

    def listing(q8_op, q8_stack):
        sass = (
            f"\t\tFunction : {f32}\n  /*0a30*/ HMMA.1688.F32.TF32 R24, R4, R20, R24 ;\n"
            f"\t\tFunction : {q8}\n  /*0a30*/ {q8_op} R24, R4, R20, R24 ;\n"
        )
        usage = "".join(
            f" Function {n}:\n  REG:{r} STACK:{st} SHARED:0 LOCAL:0 CONSTANT[0]:608\n"
            for n, r, st in ((f32, 235, 0), (q8, 231, q8_stack))
        )

        def run(cmd, **kw):
            out = sass if "-sass" in cmd else usage
            return type("Done", (), {"stdout": out})()

        monkeypatch.setattr(chip_smoke.subprocess, "run", run)

    def check():
        return chip_smoke.compiled_bodies(
            Path("rff_score-x.so"), Path("cuobjdump"), mma_in, simt, spill_free
        )

    listing("HMMA.1688.F32.TF32", 0)
    bodies = check()
    assert bodies[q8]["sass"] == {"HMMA.1688.F32.TF32": 1}
    assert bodies[q8]["stack_bytes"] == 0
    listing("HMMA.1688.F32.TF32", 72)
    with pytest.raises(chip_smoke.PhaseFailed, match="72 stack/local bytes"):
        check()
    listing("FFMA", 0)
    with pytest.raises(chip_smoke.PhaseFailed, match="holds no tensor-core MMA"):
        check()


def test_compiled_bodies_hold_b6_b7_on_the_tensor_cores_without_spills(monkeypatch):
    """chip_smoke.py's ``compiled`` check of the fastfood library: every d'
    instantiation of both kernels must hold a tensor-core MMA (the readout)
    and no stack or local bytes; the second pass, an add, is not checked."""
    chip_smoke = _load_chip_smoke()
    mma_in, simt, spill_free = chip_smoke.TENSOR_CORE_BODIES["fastfood-"]
    assert (mma_in, simt, spill_free) == ("fastfood_tile", None, True)
    f32 = "_ZN12_GLOBAL__N_113fastfood_tileILb0ELi1024EEEvPKf"
    q8 = "_ZN12_GLOBAL__N_113fastfood_tileILb1ELi1024EEEvPKf"
    second = "_ZN12_GLOBAL__N_117fastfood_finalizeEPKfiiiS1_S1_Pf"

    def listing(q8_op, q8_stack):
        sass = (
            f"\t\tFunction : {f32}\n  /*0a30*/ HMMA.1688.F32.TF32 R24, R4, R20, R24 ;\n"
            f"\t\tFunction : {q8}\n  /*0a30*/ {q8_op} R24, R4, R20, R24 ;\n"
            f"\t\tFunction : {second}\n  /*0a30*/ FADD R1, R2, R3 ;\n"
        )
        usage = "".join(
            f" Function {n}:\n  REG:{r} STACK:{st} SHARED:0 LOCAL:0 CONSTANT[0]:608\n"
            for n, r, st in ((f32, 128, 0), (q8, 128, q8_stack), (second, 32, 0))
        )

        def run(cmd, **kw):
            out = sass if "-sass" in cmd else usage
            return type("Done", (), {"stdout": out})()

        monkeypatch.setattr(chip_smoke.subprocess, "run", run)

    def check():
        return chip_smoke.compiled_bodies(
            Path("fastfood-x.so"), Path("cuobjdump"), mma_in, simt, spill_free
        )

    listing("HMMA.1688.F32.TF32", 0)
    assert set(check()) == {f32, q8}
    listing("HMMA.1688.F32.TF32", 248)
    with pytest.raises(chip_smoke.PhaseFailed, match="248 stack/local bytes"):
        check()
    listing("FFMA", 0)
    with pytest.raises(chip_smoke.PhaseFailed, match="holds no tensor-core MMA"):
        check()
