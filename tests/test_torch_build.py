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
        assert build.includes(source) == [source, "attn_tile.cuh"]
    assert build.includes("quadform.cu") == ["quadform.cu"]


def test_an_edited_header_changes_the_library_path(csrc):
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    before = {s: build.library_path(s) for s in sources}
    with open(csrc / "attn_tile.cuh", "ab") as f:
        f.write(b"\n// one more line\n")
    after = {s: build.library_path(s) for s in sources}
    changed = {s for s in sources if before[s] != after[s]}
    assert changed == {"flash_attn.cu", "maclaurin_attn.cu"}
    assert all(after[s].name.startswith(s.removesuffix(".cu") + "-") for s in sources)


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
