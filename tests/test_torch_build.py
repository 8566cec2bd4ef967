"""The kernel build (admm_library_torch/ops/_build.py) with a stand-in
for nvcc: every csrc/*.cu (the two kernels and the conditional-node
library) becomes its own library, all compilers run at
once, an unchanged source is not rebuilt, and a failed compile raises
after the others finish, leaving no temporary files."""
import os
import stat
import sys

import pytest

from admm_library_torch.ops import _build

FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
src = args[-1]
out = args[args.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(os.path.basename(src) + "\\n")
time.sleep(0.2)
if os.path.basename(src) == os.environ.get("FAKE_NVCC_FAIL"):
    print("error: this source does not compile")
    sys.exit(1)
print("ptxas info    : Used 8 registers")
with open(out, "w") as f:
    f.write(src)
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return log


def _calls(log):
    return log.read_text().split() if log.exists() else []


def test_each_source_builds_its_own_library_once(fake_nvcc):
    stems = sorted(p.stem for p in _build.sources())
    assert stems == ["fused_iterate", "graph_cond", "pallas_cg"]
    libs = _build.build(verbose=True)
    assert sorted(libs) == stems
    for stem, (path, log) in libs.items():
        assert path == _build.library_path(_build.CSRC_DIR / f"{stem}.cu")
        assert path.name.startswith(f"lib{stem}_") and path.exists()
        assert "registers" in log
    assert sorted(_calls(fake_nvcc)) == [f"{s}.cu" for s in stems]
    # Existing libraries load without another compile.
    again = _build.build()
    assert {k: v[0] for k, v in again.items()} == {
        k: v[0] for k, v in libs.items()}
    assert len(_calls(fake_nvcc)) == len(stems)


def test_a_failed_compile_raises_and_cleans_up(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "pallas_cg.cu")
    with pytest.raises(RuntimeError, match="does not compile"):
        _build.build()
    # The other sources still finished and were kept; no temporaries.
    left = sorted(os.listdir(_build.BUILD_DIR))
    assert len(left) == 2 and left[0].startswith("libfused_iterate_")
    assert left[1].startswith("libgraph_cond_")
    assert sorted(_calls(fake_nvcc)) == ["fused_iterate.cu", "graph_cond.cu",
                                         "pallas_cg.cu"]


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build.library_path(src)
    src.write_text("// two")
    second = _build.library_path(src)
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(src) != second
