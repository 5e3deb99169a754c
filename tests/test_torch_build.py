"""The kernel build's cache key (ray_tpu_torch/ops/_build.py), on the
CPU: a library is named by a hash of its source, of every ``#include
"..."`` file under ``csrc/`` the source reaches, and of nvcc's flags, so
an edited header is rebuilt and a library built before the edit is not
reused. Nothing is compiled here."""

import torch

from ray_tpu_torch.ops import _build

torch.set_num_threads(1)


def test_editing_an_included_header_changes_the_library_name(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "inner.cuh").write_text("#pragma once\nint inner();\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "kern.cu"
    src.write_text('#include <stdint.h>\n  #  include "outer.cuh"\n'
                   "int k() { return 0; }\n")
    other = tmp_path / "plain.cu"
    other.write_text("int p() { return 1; }\n")
    assert _build._local_includes(src) == [tmp_path / "inner.cuh",
                                          tmp_path / "outer.cuh"]
    before, plain = _build._target(src), _build._target(other)
    assert before.name.startswith("libkern-") and before.suffix == ".so"
    # A header reached through another header: a new name.
    (tmp_path / "inner.cuh").write_text("#pragma once\nint inner(int);\n")
    after = _build._target(src)
    assert after != before
    # The same bytes give the same name; a source without the header
    # keeps its name.
    assert _build._target(src) == after
    assert _build._target(other) == plain


def test_the_flash_sources_hash_their_shared_header():
    # The paged decode source uses the header's mbarrier and bulk-copy
    # helpers too: all three libraries are rebuilt when it changes.
    srcs = _build.sources()
    for name in ("flash_fwd", "flash_bwd", "paged_decode"):
        incs = _build._local_includes(srcs[name])
        assert [p.name for p in incs] == ["hopper.cuh"], name
