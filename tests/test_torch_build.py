"""The port's kernel build helper (``repro_torch.kernels._build``): which
files a library's rebuild watches. Only ``.cu`` sources go to ``nvcc``; the
headers they include by ``#include "..."`` are watched as well, so an edit
to a shared header rebuilds every library that includes it."""
import os

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import kernel as fk


def test_flash_sources_include_the_shared_hopper_header():
    hdr = os.path.join(os.path.dirname(fk.SOURCE), "hopper.cuh")
    assert _build.local_headers(fk.SOURCE) == [hdr]
    assert _build.local_headers(fk.BWD_SOURCE) == [hdr]
    assert _build.local_headers(hdr) == []


def _touch(path, mtime):
    os.utime(path, (mtime, mtime))


@pytest.mark.parametrize("newer,want", [
    (None, False),            # the library is newer than everything
    ("src", True),            # the source was edited
    ("hdr", True),            # a header it includes was edited
    ("nested", True),         # a header that header includes was edited
    ("unrelated", False),     # a header nobody includes
])
def test_library_is_stale_when_a_source_or_an_included_header_is_newer(
        tmp_path, newer, want):
    files = {"src": tmp_path / "k.cu", "hdr": tmp_path / "a.cuh",
             "nested": tmp_path / "b.cuh", "unrelated": tmp_path / "c.cuh"}
    files["src"].write_text('#include <math.h>\n#include "a.cuh"\n')
    files["hdr"].write_text('#pragma once\n  # include "b.cuh"\n')
    files["nested"].write_text("#pragma once\n")
    files["unrelated"].write_text("#pragma once\n")
    out = tmp_path / "libk.so"
    out.write_bytes(b"")
    for f in files.values():
        _touch(f, 1000)
    _touch(out, 2000)
    if newer is not None:
        _touch(files[newer], 3000)
    assert _build.stale(out, [str(files["src"])]) is want
    assert _build.local_headers(str(files["src"])) == [
        str(files["hdr"]), str(files["nested"])]


def test_missing_library_is_stale(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("")
    assert _build.stale(tmp_path / "libk.so", [str(src)])
