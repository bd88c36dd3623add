"""muninn_tpu_torch.ops._build without a CUDA compiler: a stand-in ``nvcc``
records what ``_build`` asks of it.

The kernels' sources include headers from ``csrc/`` (``topk_merge.cuh``), so
``_build`` passes that directory with ``-I`` (the probes build copies of a
source from elsewhere) and names each library by a hash that covers the
headers too: a changed header rebuilds every source.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import os

import pytest

from muninn_tpu_torch.ops import _build


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A csrc/ with one source and one header, a build directory, and an
    ``nvcc`` that writes its arguments into the library it is asked for."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then echo fake; exit 0; fi\n'
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'echo "$@" > "$out"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "HEADER_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_build_passes_the_header_directory(fake_tree):
    lib = _build.build(["k"])["k"]
    args = lib.read_text().split()
    assert args[args.index("-I") + 1] == str(fake_tree)
    assert "arch=compute_90a,code=sm_90a" in args


def test_a_changed_header_rebuilds(fake_tree):
    first = _build.build(["k"])["k"]
    assert _build.build(["k"])["k"] == first  # unchanged: found, not rebuilt
    (fake_tree / "h.cuh").write_text("// v2\n")
    second = _build.build(["k"])["k"]
    assert second != first and second.is_file() and first.is_file()
    assert os.path.dirname(second) == os.path.dirname(first)
