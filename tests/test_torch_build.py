"""The kernel build's cache key: a library is rebuilt when its source or
any header beside it changes. Needs no nvcc: only the target name is
computed."""

import pytest

from fedml_tpu_torch.ops import build


@pytest.mark.parametrize("header", ["common.cuh", "common.h"])
def test_target_changes_with_header(tmp_path, monkeypatch, header):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text(f'#include "{header}"\n')
    (tmp_path / header).write_text("constexpr int TILE = 64;\n")
    before = build._target("kern")
    assert build._target("kern") == before  # the key is stable
    (tmp_path / header).write_text("constexpr int TILE = 128;\n")
    after = build._target("kern")
    assert after != before
    assert after.parent == before.parent == build.BUILD_DIR
    assert after.name.startswith("kern-") and after.suffix == ".so"
