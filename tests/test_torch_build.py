"""The port's kernel builder: what it hashes into a library's name.

No ``nvcc`` runs here; these check the rebuild rule, that a library's name
changes with every file under its kernel's ``csrc/``.
"""
import os

from repro_torch.kernels import build


def make_kernel(root, files):
    csrc = os.path.join(root, "demo", "csrc")
    os.makedirs(csrc, exist_ok=True)
    for name, text in files.items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(text)


def test_library_name_follows_every_source_file(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_HERE", str(tmp_path))
    make_kernel(tmp_path, {"demo.cu": '#include "demo.cuh"\n',
                           "demo.cuh": "// v1\n"})
    first = build.library_path("demo")
    assert build.library_path("demo") == first       # stable
    assert [os.path.basename(p) for p in build.sources("demo")] == [
        "demo.cu", "demo.cuh"]
    make_kernel(tmp_path, {"demo.cuh": "// v2\n"})      # an edited header
    second = build.library_path("demo")
    assert second != first
    make_kernel(tmp_path, {"extra.cuh": "// new\n"})    # a new header
    assert build.library_path("demo") not in (first, second)
    assert os.path.dirname(first) == build.build_dir("demo")


def test_library_name_follows_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_HERE", str(tmp_path))
    make_kernel(tmp_path, {"demo.cu": "// kernel\n"})
    first = build.library_path("demo")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("demo") != first
