"""The native build's first use from several threads at once
(keystone_tpu_torch/kernels/build.py): two serving replicas priming
together must build a library once and load one copy of it.  Built
here with g++ (csrc/text.cpp, the host text chain)."""

import threading

import pytest

from keystone_tpu_torch.kernels import build
from keystone_tpu_torch.ops import nlp_native


def test_two_threads_build_and_load_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    compiles = []
    popen = build.subprocess.Popen

    def counting_popen(cmd, *a, **kw):
        compiles.append(cmd)
        return popen(cmd, *a, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", counting_popen)
    start = threading.Barrier(2)
    libs, errors = [None, None], []

    def load(i):
        try:
            start.wait(timeout=30)
            libs[i] = nlp_native._lib() if i == 0 else build.load("text")
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert libs[0] is libs[1] is not None
    assert len(compiles) == 1
    assert [p.suffix for p in tmp_path.iterdir() if p.name.startswith("libtext")] == [".so"]
    assert not list(tmp_path.glob("*.tmp"))


def test_compiler_output_is_named_by_process_and_thread(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    seen = []

    class Failing:
        returncode = 1

        def __init__(self, cmd, *a, **kw):
            seen.append(cmd[cmd.index("-o") + 1])
            self.args = cmd

        def communicate(self):
            return "no compiler here", None

    monkeypatch.setattr(build.subprocess, "Popen", Failing)
    with pytest.raises(build.KernelError, match="exited 1"):
        build.build(["text"])
    (tmp,) = seen
    assert tmp.endswith(f".{build.os.getpid()}.{threading.get_ident()}.tmp")
    assert issubclass(build.KernelError, RuntimeError)
