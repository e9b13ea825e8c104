"""Guards on the port's boundaries: it never imports jax (on the short-
and the long-read path), its typer's per-locus step stays the reference's
text, it never falls back from the card to the CPU, and a CUDA tensor
never reaches a plain version."""

import ast
import difflib
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import hla_la_tpu_torch
from hla_la_tpu.models.typer import HLATyper
from hla_la_tpu_torch import _build
from hla_la_tpu_torch import device as port_device
from hla_la_tpu_torch.models.typer import BACKEND, TorchHLATyper
from hla_la_tpu_torch.ops import banded_nw as port_nw
from hla_la_tpu_torch.ops import pair_ll as port_pair
from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SLICE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    import tempfile
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from hla_la_tpu_torch.models.pipeline import run_hla_typing
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator
    from hla_la_tpu.utils.config import RunConfig
    rng = np.random.default_rng(31)
    sim = simulate_prg_package(rng, backbone_length=1200, n_haplotypes=4)
    with tempfile.TemporaryDirectory() as td:
        pkg = sim.write_package(td + "/pkg")
        rs = ReadSimulator(rng, read_length=90, fragment_mean=300,
                           fragment_sd=25)
        pairs = []
        for h in (1, 2):
            seq, levels = sim.linearized(h)
            pairs += rs.simulate_pairs_from_string(seq, levels, 8.0)
        fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
        res = run_hla_typing(pkg, pairs=fq, output_dir=td + "/out",
                             device="cpu")
        long_reads = []
        for h in (1, 2):
            seq, levels = sim.linearized(h)
            long_reads += rs.simulate_unpaired_from_string(
                seq, levels, 3.0, read_length=1100, name_prefix=f"lr{h}")
        res_long = run_hla_typing(
            pkg, unpaired=[r.to_fastq() for r in long_reads],
            output_dir=td + "/out_long", device="cpu",
            cfg=RunConfig(long_reads="ont2d"))
    assert res.results and res.n_pairs_aligned > 0
    assert res_long.results
    assert [m for m in sys.modules if m == "jax" or m.startswith("jax.")] \\
        == ["jax"] and sys.modules["jax"] is None
    print("SLICE_OK", len(res.results))
""")


def test_cpu_slice_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SLICE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SLICE_OK" in proc.stdout


def test_type_locus_is_the_reference_text():
    """Only the two device calls differ from hla_la_tpu's _type_locus."""
    ref = inspect.getsource(HLATyper._type_locus).splitlines()
    port = inspect.getsource(TorchHLATyper._type_locus).splitlines()
    changed = [line for line in difflib.unified_diff(ref, port, n=0,
                                                     lineterm="")
               if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert changed == [
        "-                    onehot, contrib, mismatch, backend=self.backend)",
        "+                    onehot, contrib, mismatch, device=self.device)",
        "-        pair_LL = pair_ll_reduction(LLmat, backend=self.backend)",
        "+        pair_LL = pair_ll_reduction(LLmat, device=self.device)",
    ], changed
    # the reference's dispatch line, unchanged, keeps the port on the
    # dense one-hot formula
    assert any('if self.backend in ("auto", "numpy")' in line
               for line in port)
    assert BACKEND not in ("auto", "numpy")


def test_type_loci_parallel_is_disabled():
    assert TorchHLATyper._type_loci_parallel(None, 1, 2, x=3) is None


def test_resolve_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_device.resolve("cuda")
    with pytest.raises(ValueError):
        port_device.resolve("meta")
    assert port_device.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def _fake(device_type, shape=(2, 8)):
    return SimpleNamespace(device=torch.device(device_type), shape=shape)


def test_cuda_tensors_never_reach_a_plain_version(monkeypatch):
    calls = []

    def record(name):
        def fn(*args, **kwargs):
            calls.append(name)
            return name
        return fn

    monkeypatch.setattr(port_nw, "banded_nw_cuda", record("nw_kernel"))
    monkeypatch.setattr(port_nw, "banded_nw_long_cuda",
                        record("nw_long_kernel"))
    monkeypatch.setattr(port_nw, "banded_nw_plain", record("nw_plain"))
    monkeypatch.setattr(port_pair, "pair_ll_diff_cuda", record("pair_kernel"))
    monkeypatch.setattr(port_pair, "pair_ll_diff_plain", record("pair_plain"))
    cuda, cuda_lens = _fake("cuda"), _fake("cuda", (2,))
    # refs [B, L + W]: W = 32 is K1's widest band, W = 33 K2's narrowest
    k1_refs, k2_refs = _fake("cuda", (2, 40)), _fake("cuda", (2, 41))
    assert port_nw._forward(cuda, cuda_lens, k1_refs, {}) == "nw_kernel"
    assert port_nw._forward(cuda, cuda_lens, k2_refs, {}) == "nw_long_kernel"
    assert port_nw._forward(cuda, cuda_lens, _fake("cuda", (2, 264)),
                            {}) == "nw_long_kernel"
    assert port_pair._pair_ll_diff(cuda) == "pair_kernel"
    assert calls == ["nw_kernel", "nw_long_kernel", "nw_long_kernel",
                     "pair_kernel"]
    cpu = _fake("cpu")
    assert port_nw._forward(cpu, cpu, _fake("cpu", (2, 264)),
                            {}) == "nw_plain"
    assert port_pair._pair_ll_diff(cpu) == "pair_plain"
    with pytest.raises(ValueError):
        port_nw._forward(_fake("meta"), None, None, {})


def test_tensor_on_another_device_is_refused():
    with pytest.raises(ValueError, match="expected"):
        port_device.to_device(SimpleNamespace(device=torch.device("cuda")),
                              torch.device("cpu"))


def test_kernel_wrappers_refuse_cpu_tensors():
    u8 = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        banded_nw_cuda(u8, torch.zeros(2), torch.zeros((2, 36),
                                                       dtype=torch.uint8), {})
    with pytest.raises(ValueError, match="CUDA"):
        banded_nw_long_cuda(u8, torch.zeros(2),
                            torch.zeros((2, 260), dtype=torch.uint8), {})
    with pytest.raises(ValueError, match="CUDA"):
        pair_ll_diff_cuda(torch.zeros((3, 5)))
    assert banded_nw_cuda.launches == 0 and pair_ll_diff_cuda.launches == 0
    assert banded_nw_long_cuda.launches == 0


def test_kernels_build_inside_the_checkout_or_a_user_cache(tmp_path,
                                                         monkeypatch):
    """A source checkout builds into its own build/; an installed package
    (no pyproject.toml beside it) into the per-user cache."""
    assert _build.build_dir() == (Path(REPO) / "build" / "hla_la_tpu_torch")
    installed = tmp_path / "site-packages" / "hla_la_tpu_torch"
    installed.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(installed) == tmp_path / "cache" / \
        "hla_la_tpu_torch"


def test_failed_build_raises_and_leaves_no_objects(tmp_path, monkeypatch):
    """Every source compiles at once; when one fails, the build raises with
    that compiler's output and removes the objects of the others."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent("""\
        #!/bin/sh
        for a; do case "$prev" in -o) out=$a;; esac; prev=$a; done
        : > "$out"
        case "$*" in *pair_ll.cu*) echo "pair_ll.cu: error"; exit 2;; esac
        """))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="pair_ll.cu: error"):
        _build.build()
    assert list((tmp_path / "out").iterdir()) == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """The smoke run drives the port alone: no import of jax or of any
    hla_la_tpu module, at the top or inside a function."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "hla_la_tpu_torch.cli" in names
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "hla_la_tpu"}, roots


def test_no_fallback_in_the_device_path():
    """Nothing in the package catches a build or launch failure."""
    pkg_dir = os.path.dirname(hla_la_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg_dir):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as fh:
                    src = fh.read()
                assert "except" not in src, fn
                assert "import jax" not in src, fn
