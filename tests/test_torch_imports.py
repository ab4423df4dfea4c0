"""The port stands alone: every module of raft_tla_tpu_torch and
chip_smoke.py import with JAX and the JAX package blocked, and
chip_smoke.py refuses to report a result where there is no CUDA
device."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        import raft_tla_tpu_torch, chip_smoke
        names = [m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")]
        for n in names:
            __import__(n)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 32


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Here there is no CUDA device: the script exits non-zero and prints
    no result line (it also needs the package beside it)."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_sim_modules_import_without_jax():
    """The random-walk slice's modules (the engine, the PRNG) and the
    modules it changed import with JAX and the JAX package blocked, and
    the package walk reaches them."""
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        new = ["raft_tla_tpu_torch.sim", "raft_tla_tpu_torch.sim.walker",
               "raft_tla_tpu_torch.utils.prng"]
        changed = ["raft_tla_tpu_torch." + m for m in (
            "cli", "convert", "engine.expand", "engine.fingerprint",
            "ops.kernels", "spec", "spec.raft_ir")]
        assert set(new) <= names, sorted(set(new) - names)
        for n in new + changed:
            __import__(n)
        from raft_tla_tpu_torch.sim import SimEngine
        from raft_tla_tpu_torch.spec import get_spec
        assert get_spec("raft").sim_progress is not None
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_spill_modules_import_without_jax():
    """The spill slice's modules (the engine, the host table, the
    portable image) and the modules it changed import with JAX and the
    JAX package blocked, the package walk reaches them, and the spill
    engine refuses to start without CUDA unless asked for the CPU."""
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        new = ["raft_tla_tpu_torch.engine.spill",
               "raft_tla_tpu_torch.engine.host_table",
               "raft_tla_tpu_torch.resil.portable"]
        changed = ["raft_tla_tpu_torch." + m for m in (
            "cli", "engine.bfs", "resil", "resil.supervisor")]
        assert set(new) <= names, sorted(set(new) - names)
        for n in new + changed:
            __import__(n)
        from raft_tla_tpu_torch.config import Bounds, ModelConfig
        from raft_tla_tpu_torch.engine.spill import SpillEngine
        cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                          bounds=Bounds.make(max_log_length=1))
        try:
            SpillEngine(cfg)
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("SpillEngine started without CUDA")
        SpillEngine(cfg, device="cpu")
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr


def test_paxos_modules_import_without_jax():
    """The paxos tenant's modules and the modules its slice changed
    import with JAX and the JAX package blocked, the package walk reaches
    them, and the registry serves both specs."""
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        new = ["raft_tla_tpu_torch.spec.paxos." + m for m in (
            "config", "model", "layout", "oracle", "kernels",
            "vpredicates", "fingerprint", "ir")] + \
            ["raft_tla_tpu_torch.spec.paxos"]
        changed = ["raft_tla_tpu_torch." + m for m in (
            "cli", "convert", "cfg.parser", "spec", "spec.raft_ir",
            "engine.bfs", "engine.spill", "engine.expand", "sim.walker")]
        assert set(new) <= names, sorted(set(new) - names)
        for n in new + changed:
            __import__(n)
        from raft_tla_tpu_torch.spec import get_spec, spec_names
        assert spec_names() == ("paxos", "raft")
        ir = get_spec("paxos")
        assert ir.fingerprint() == "d6d7a456cec9"
        assert ir.u32_keys == ("msgs",) and get_spec("raft").u32_keys == \
            ("bag",)
        assert ir.default_config().spec == "paxos"
        try:
            get_spec("tla")
        except ValueError as e:
            assert str(e) == "unknown spec 'tla'; known specs: paxos, raft"
        else:
            raise AssertionError("an unknown spec was served")
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_obs_modules_import_without_jax_and_do_no_work():
    """The observability package and the modules its slice changed
    import with JAX and the JAX package blocked, the package walk
    reaches them, and importing them initialises no CUDA, starts no
    profiler and opens no file."""
    code = textwrap.dedent("""
        import os, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        import torch
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        new = ["raft_tla_tpu_torch.obs"] + ["raft_tla_tpu_torch.obs." + m
            for m in ("metrics", "spans", "ledger", "heartbeat",
                      "registry", "resources")]
        changed = ["raft_tla_tpu_torch." + m for m in (
            "cli", "engine.bfs", "engine.graph", "engine.cuda_ext",
            "resil.supervisor")]
        assert set(new) <= names, sorted(set(new) - names)
        fds = len(os.listdir("/proc/self/fd"))
        for n in new + changed:
            __import__(n)
        assert len(os.listdir("/proc/self/fd")) == fds
        assert not torch.cuda.is_initialized()
        from torch.autograd.profiler import _is_profiler_enabled
        assert not _is_profiler_enabled
        from raft_tla_tpu_torch.obs import NULL_OBS
        assert not NULL_OBS.enabled and NULL_OBS.run_id is None
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_obs_report_imports_without_jax_and_does_no_work():
    """``obs/report.py`` (the query half behind ``cli obs``) and the
    modules its slice changed import with JAX and the JAX package
    blocked, the package walk reaches it, and importing it loads no
    torch, opens no file and starts no profiler: ``cli obs`` answers
    without the engines."""
    code = textwrap.dedent("""
        import os, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        fds = len(os.listdir("/proc/self/fd"))
        import raft_tla_tpu_torch.obs.report as report
        assert "torch" not in sys.modules
        assert len(os.listdir("/proc/self/fd")) == fds
        assert report.diff_runs({"depth": 1}, {"depth": 1})[
            "verdict"] == "clean"
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        assert "raft_tla_tpu_torch.obs.report" in names
        for n in ("cli", "engine.spill", "sim.walker"):
            __import__("raft_tla_tpu_torch." + n)
        import torch
        assert not torch.cuda.is_initialized()
        from torch.autograd.profiler import _is_profiler_enabled
        assert not _is_profiler_enabled
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serve_modules_import_without_jax_and_refuse_without_cuda():
    """The batched serving slice's modules (jobs, cache, wave state, the
    bucket engine, the scheduler) and the modules it changed import with
    JAX and the JAX package blocked, the package walk reaches them,
    importing them initialises no CUDA, and the entry points refuse to
    start without CUDA unless asked for the CPU."""
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        import torch
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        new = ["raft_tla_tpu_torch.serve"] + [
            "raft_tla_tpu_torch.serve." + m for m in (
                "jobs", "cache", "wavestate", "batch", "scheduler")]
        changed = ["raft_tla_tpu_torch." + m for m in (
            "cli", "engine.bfs", "engine.expand", "engine.graph",
            "engine.spill", "ops.vpredicates", "spec", "spec.raft_ir",
            "spec.paxos.ir", "spec.paxos.vpredicates", "resil.chaos")]
        assert set(new) <= names, sorted(set(new) - names)
        for n in new + changed:
            __import__(n)
        assert not torch.cuda.is_initialized()
        from raft_tla_tpu_torch.config import Bounds, ModelConfig
        from raft_tla_tpu_torch.serve import BucketEngine, Job, run_jobs
        cfg = ModelConfig(n_servers=2, init_servers=(0, 1), values=(1,),
                          bounds=Bounds.make(max_log_length=1))
        for start in (lambda: BucketEngine(cfg),
                      lambda: run_jobs([Job(cfg, max_depth=1)])):
            try:
                start()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e)
            else:
                raise AssertionError("serving started without CUDA")
        BucketEngine(cfg, device="cpu")
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr


def test_daemon_modules_import_without_jax(tmp_path):
    """The daemon slice's modules (the executable cache, the intake, the
    daemon) import with JAX and the JAX package blocked, do no work at
    import (no CUDA, no file, no source hash), and the daemon refuses to
    start without CUDA unless asked for the CPU."""
    code = textwrap.dedent("""
        import os, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["raft_tla_tpu"] = None
        sys.path.insert(0, REPO)
        import torch
        import raft_tla_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            raft_tla_tpu_torch.__path__, "raft_tla_tpu_torch.")}
        new = ["raft_tla_tpu_torch.serve." + m for m in (
            "exec_cache", "intake", "daemon")]
        assert set(new) <= names, sorted(set(new) - names)
        for n in new + ["raft_tla_tpu_torch.cli",
                        "raft_tla_tpu_torch.serve"]:
            __import__(n)
        assert not torch.cuda.is_initialized()
        assert os.listdir(".") == []
        from raft_tla_tpu_torch.serve import exec_cache
        assert exec_cache._CODE_FP is None
        from raft_tla_tpu_torch.serve import Daemon, ExecCache
        try:
            Daemon("spool")
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("the daemon started without CUDA")
        assert os.listdir(".") == []
        Daemon("spool", device="cpu", exec_cache=ExecCache("ec"))
        assert sorted(os.listdir(".")) == ["ec", "spool"]
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "raft_tla_tpu") and sys.modules[m]]
        assert not bad, bad
    """).replace("REPO", repr(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
