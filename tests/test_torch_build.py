"""The kernel build cache (ops/kernels/build.py) on the CPU: a library's
file name changes with the bytes of its source, of every header of the
kernels directory and of the flags, so an edited header never reuses a
stale library.  Nothing is compiled here."""

import os
import re
import shutil

import pytest

import torch_threads  # noqa: F401

from inverse_path_tracer_torch.ops.kernels import build


@pytest.fixture()
def kernels_copy(tmp_path, monkeypatch):
    for f in os.listdir(build.HERE):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(build.HERE, f), tmp_path / f)
    monkeypatch.setattr(build, "HERE", str(tmp_path))
    return tmp_path


def test_library_path_tracks_sources_headers_and_flags(kernels_copy, monkeypatch):
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert len(set(before.values())) == len(build.SOURCES)
    assert all(os.path.dirname(p) == build.BUILD_DIR for p in before.values())
    assert before == {n: build.library_path(n) for n in build.SOURCES}  # stable

    header = kernels_copy / "render_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after_header = {n: build.library_path(n) for n in build.SOURCES}
    assert all(after_header[n] != before[n] for n in build.SOURCES)

    src = kernels_copy / build.SOURCES["render_bwd"]
    src.write_bytes(src.read_bytes() + b"\n")
    after_src = {n: build.library_path(n) for n in build.SOURCES}
    assert after_src["render_bwd"] != after_header["render_bwd"]
    assert after_src["render_fwd"] == after_header["render_fwd"]

    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("render_fwd") != after_src["render_fwd"]


def test_every_include_of_a_source_is_a_hashed_header():
    """The hash covers the headers of the kernels directory, so a source may
    include only those (and system headers)."""
    local = {f for f in os.listdir(build.HERE) if f.endswith(".cuh")}
    for src in build.SOURCES.values():
        with open(os.path.join(build.HERE, src)) as f:
            quoted = re.findall(r'#include\s+"([^"]+)"', f.read())
        assert quoted and set(quoted) <= local, (src, quoted)
