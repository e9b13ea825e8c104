"""Guards on the port's boundaries: no file of it imports jax or the JAX
package, its whole CPU path (short reads, long reads, BAM input) runs with
both blocked, the modules it copied from the reference stay the reference's
text up to a listed set of differences, it never falls back from the card
to the CPU, and a CUDA tensor never reaches a plain version."""

import ast
import difflib
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import hla_la_tpu_torch
from hla_la_tpu_torch import _build
from hla_la_tpu_torch import device as port_device
from hla_la_tpu_torch.models.aligner import ReadAligner
from hla_la_tpu_torch.models.typer import HLATyper
from hla_la_tpu_torch.ops import banded_nw as port_nw
from hla_la_tpu_torch.ops import pair_ll as port_pair
from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "hla_la_tpu_torch"
REFERENCE = REPO / "hla_la_tpu"
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "hla_la_tpu"}


def _imports(path: Path) -> list[str]:
    """Every absolute module name imported anywhere in the file: at the
    top, inside functions, classes, conditionals and try blocks."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("rel",
                         PORT_FILES + ["chip_smoke.py", "bench_nw.py",
                                       "bench_workers.py"])
def test_file_imports_neither_jax_nor_the_jax_package(rel):
    roots = {n.split(".")[0] for n in _imports(REPO / rel)}
    assert not roots & FORBIDDEN, (rel, roots & FORBIDDEN)
    if rel in PORT_FILES:   # the package stands without the root's scripts
        assert not roots & {"chip_smoke", "bench_nw", "bench_workers"}, rel
    text = (REPO / rel).read_text()
    assert "import_module" not in text and "__import__" not in text, rel


def test_the_import_guard_sees_nested_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(textwrap.dedent("""
        def f():
            try:
                from hla_la_tpu.io import fastq
            except ImportError:
                import jax.numpy as jnp
        from . import sibling
        from .hla_la_tpu import not_the_package
    """))
    assert sorted(_imports(probe)) == ["hla_la_tpu.io", "jax.numpy"]


_BLOCKED_SLICE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["hla_la_tpu"] = None
    import os
    import tempfile
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from hla_la_tpu_torch.cli import main
    from hla_la_tpu_torch.io.bam import (BamRecord, BamWriter, FLAG_PAIRED,
                                         FLAG_READ1, FLAG_READ2)
    from hla_la_tpu_torch.io.fastq import write_fastq
    from hla_la_tpu_torch.models.pipeline import run_hla_typing
    from hla_la_tpu_torch.sim import ReadSimulator, simulate_prg_package
    from hla_la_tpu_torch.utils.config import RunConfig
    rng = np.random.default_rng(31)
    sim = simulate_prg_package(rng, backbone_length=1200, n_haplotypes=4)
    with tempfile.TemporaryDirectory() as td:
        pkg = sim.write_package(td + "/pkg")
        rs = ReadSimulator(rng, read_length=90, fragment_mean=300,
                           fragment_sd=25)
        pairs = []
        for h in (1, 2):
            seq, levels = sim.linearized(h)
            pairs += rs.simulate_pairs_from_string(seq, levels, 8.0,
                                                   name_prefix=f"h{h}")
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
        # the CLI on FASTQ and on a BAM whose contig matches a
        # knownReferences spec
        write_fastq(td + "/R_1.fq", [a for a, _ in fq])
        write_fastq(td + "/R_2.fq", [b for _, b in fq])
        common = ["--action", "HLA", "--graph", pkg.dir, "--sampleID", "S1",
                  "--device", "cpu"]
        assert main(common + ["--FASTQ1", td + "/R_1.fq", "--FASTQ2",
                              td + "/R_2.fq", "--outputDirectory",
                              td + "/cli_fq"]) == 0
        # align shards and their merge (parallel_host's packers)
        for host in ("0", "1"):
            assert main(common + ["--FASTQ1", td + "/R_1.fq", "--FASTQ2",
                                  td + "/R_2.fq", "--outputDirectory",
                                  td + "/host" + host, "--nHosts", "2",
                                  "--hostIdx", host, "--shardDir",
                                  td + "/shards"]) == 0
        assert main(common + ["--mergeShards", td + "/shards",
                              "--outputDirectory", td + "/cli_merged"]) == 0
        with open(os.path.join(pkg.dir, "knownReferences", "fake.txt"),
                  "w") as fh:
            fh.write("contigID\\tcontigLength\\tExtractCompleteContig\\t"
                     "PartialExtraction_Start\\tPartialExtraction_Stop\\n")
            fh.write("chr6\\t100000\\t1\\t\\t\\n")
        w = BamWriter(td + "/in.bam", [("chr6", 100000)])
        for r1, r2 in fq:
            for mate, r in ((FLAG_READ1, r1), (FLAG_READ2, r2)):
                w.write(BamRecord(name=r.name, flag=FLAG_PAIRED | mate,
                                  ref_id=0, pos=0, mapq=60,
                                  cigar=[(len(r.seq), 0)], seq=r.seq,
                                  qual=r.qual))
        w.close()
        assert main(common + ["--BAM", td + "/in.bam", "--outputDirectory",
                              td + "/cli_bam"]) == 0
        # the linear-ALT and the assembly typers through the CLI
        panel = {f"ALT{i}": "".join(
            "ACGT"[c] for c in rng.integers(0, 4, 1500)) for i in range(3)}
        with open(td + "/panel.fa", "w") as fh:
            for name, seq in panel.items():
                fh.write(f">{name}\\n{seq}\\n")
        kir_pairs = []
        for name in ("ALT0", "ALT2"):
            kir_pairs += rs.simulate_pairs_from_string(
                panel[name], np.arange(1500), 5.0, name_prefix=name)
        write_fastq(td + "/K_1.fq", [p.r1.to_fastq() for p in kir_pairs])
        write_fastq(td + "/K_2.fq", [p.r2.to_fastq() for p in kir_pairs])
        assert main(["--action", "KIR", "--ALTpanel", td + "/panel.fa",
                     "--FASTQ1", td + "/K_1.fq", "--FASTQ2", td + "/K_2.fq",
                     "--outputDirectory", td + "/kir", "--device",
                     "cpu"]) == 0
        with open(td + "/kir/KIR_haplotypes.txt") as fh:
            kir_call = fh.read().splitlines()[1].split("\\t")[:2]
        with open(td + "/contigs.fa", "w") as fh:
            fh.write(f">c1\\n{sim.linearized(1)[0]}\\n")
        assert main(["--action", "ASM", "--graph", pkg.dir, "--ASMfasta",
                     td + "/contigs.fa", "--outputDirectory", td + "/asm",
                     "--device", "cpu"]) == 0
        with open(td + "/asm/summary.txt") as fh:
            asm_rows = fh.read().splitlines()[1:]
        tables = []
        for d in ("cli_fq", "cli_bam", "cli_merged"):
            with open(os.path.join(td, d, "hla", "R1_bestguess.txt")) as fh:
                tables.append(fh.read())
    assert res.results and res.n_pairs_aligned > 0
    assert res_long.results
    calls = [[line.split("\\t")[:3] for line in t.splitlines()]
             for t in tables]
    assert calls[0] == calls[1] and len(calls[0]) > 2
    assert tables[0] == tables[2]
    assert kir_call == ["ALT0", "ALT2"], kir_call
    assert len(asm_rows) == 2 and all(
        r.split("\\t")[4] == "0" for r in asm_rows), asm_rows
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "hla_la_tpu")]
    assert sorted(loaded) == ["hla_la_tpu", "jax"], loaded
    assert sys.modules["jax"] is None and sys.modules["hla_la_tpu"] is None
    print("SLICE_OK", len(res.results))
""")


def test_cpu_slice_runs_with_jax_blocked():
    """Short reads, long reads, the CLI on FASTQ, on a BAM and through
    align shards and their merge, and --action KIR and --action ASM, with
    jax and the JAX package both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SLICE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SLICE_OK" in proc.stdout


# Modules copied from the reference as they stand.  Each is held to the
# reference's source text: the lines below are the only ones that differ
# (comment and docstring lines that quoted host timings of the reference's
# development machine, or named the reference package).
COPIED_MODULES = """
utils/__init__ utils/config utils/timing utils/phred utils/nomenclature
io/__init__ io/fastq io/fasta io/bam io/cram io/rans io/rans_nx16 io/arith
io/tok3 io/fqzcomp native graph/__init__ graph/prg graph/package
graph/compile mapping/__init__ mapping/kmer_index mapping/seeder
mapping/global_align mapping/decoy ops/graph_dp models/alignment
models/graph_fallback models/kir_package sim/graph_sim sim/read_sim sim/truth
""".split()
COPY_DIFFS = {'graph/compile.py': ['-        # uncompressed: single-stream zlib cost ~12s '
                      'of prepareGraph at 3M',
                      '-        # levels to save ~110 MB of disk; loads get '
                      'faster too',
                      '+        # uncompressed: single-stream zlib slows '
                      'prepareGraph at 3M levels',
                      '+        # to save ~110 MB of disk; loads get faster '
                      'too'],
 'graph/package.py': ['-  PRG/graph.txt            — the PRG '
                      '(hla_la_tpu.graph.prg format)',
                      '+  PRG/graph.txt            — the PRG (the graph.prg '
                      'format)',
                      '-                    # Additional_B38_3.txt): the Perl '
                      'driver counts it as a',
                      '+                    # Additional_B38_3.txt): '
                      'HLA-LA.pl counts it as a',
                      '-            # ~5x faster (savetxt formats row-by-row '
                      'through asarray/join;',
                      '-            # it was the second-largest write_package '
                      'cost at 3M levels)',
                      '+            # faster (savetxt formats row-by-row '
                      'through asarray/join; it',
                      '+            # was the second-largest write_package '
                      'cost at 3M levels)'],
 'graph/prg.py': ['-        # visiting every node of every level cost ~20 s '
                  'at 3M levels on',
                  '-        # gene-localised gap structure.  Node iteration '
                  'order within a level',
                  '+        # visiting every node of every level is wasted on '
                  'gene-localised',
                  '+        # gap structure at 3M levels.  Node iteration '
                  'order within a level',
                  '-        python objects per line (the line parser cost '
                  '~100 s on a 3M-level',
                  '-        PRG, the dominant prepareGraph item)."""',
                  '+        python objects per line (the line parser is the '
                  'dominant',
                  '+        prepareGraph item on a 3M-level PRG)."""',
                  '-        # numpy scalar indexing per edge cost ~7s at 3M '
                  'levels',
                  '+        # numpy scalar indexing per edge is slow at 3M '
                  'levels'],
 'io/arith.py': ['-C++ fast path for the payload decode via hla_la_tpu.native '
                 'when built).',
                 '+C++ fast path for the payload decode via the native module '
                 'when built).'],
 'models/kir_package.py': ['-The reference ships no builder (the KIR panel was '
                           'prepared offline from',
                           '+The reference ships no packager (the KIR panel '
                           'was prepared offline from'],
 'mapping/seeder.py': ['-            # candidates costs ~5x, so keep it one '
                       'fancy-index pass)',
                       '+            # candidates is slow, so keep it one '
                       'fancy-index pass)'],
 'models/alignment.py': ['-            # indexing in the loop costs ~10x), '
                         'and skip the dataclass',
                         '+            # indexing in the loop is far slower), '
                         'and skip the dataclass',
                         '-    thousands of chains costs ~1s at WGS scale).  '
                         "Fills each chain's _wok",
                         '+    thousands of chains is slow at WGS scale).  '
                         "Fills each chain's _wok"],
 'models/graph_fallback.py': ['-    # (np.full + full scatter + '
                              'whole-haplotype encode ~ 9ms/call — 10%',
                              '-    # of serial alignment CPU at real PRG '
                              'scale)',
                              '+    # (np.full + full scatter + '
                              'whole-haplotype encode per call)'],
 'native.py': ['-    its source.  Fresh VMs lose the gitignored .so; without '
               'this the whole',
               '-    host hot path silently degrades to the Python fallbacks '
               '(~10x slower).',
               '+    its source.  A fresh checkout has no .so (it is '
               'gitignored); without',
               '+    this the whole host hot path silently degrades to the '
               'Python fallbacks.'],
 'utils/config.py': ['-    # min_loci=4 (measured r3): at 2 loci a fan-out '
                     'split loses what the',
                     '-    # serial path gains from the 4-thread native pair '
                     'kernel + async',
                     '-    # output writes (IMGT world, 2 x C=2200 x R=16.5k: '
                     'serial 109.6s vs',
                     '-    # 2-worker fan-out 111.5s) — workers run kernels '
                     'single-threaded.',
                     '+    # min_loci=4: at 2 loci a fan-out split loses what '
                     'the serial path',
                     '+    # gains from the multi-threaded native pair kernel '
                     '+ async output',
                     '+    # writes — workers run kernels single-threaded.']}


def _changed_lines(ref: Path, port: Path) -> list[str]:
    return [line for line in difflib.unified_diff(
                ref.read_text().splitlines(), port.read_text().splitlines(),
                n=0, lineterm="")
            if line[:1] in "+-" and line[:3] not in ("+++", "---")]


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_copied_module_is_the_reference_text(module):
    rel = module + ".py"
    changed = _changed_lines(REFERENCE / rel, PORT / rel)
    assert changed == COPY_DIFFS.get(rel, []), rel


# Modules the port rewrote in part.  Every function, method or method-less
# class that both sides define is the reference's text, except the listed
# ones: the device seams, the dropped worker-process branches, and comments
# that quoted host timings.
REWRITTEN_UNITS = {
    "ops/banded_nw": set(),
    "ops/pair_ll": {"cluster_read_ll", "pair_ll_reduction",
                    "pair_min_mismatch_row"},
    "models/aligner": {
        "ReadAligner.__init__", "ReadAligner._run_nw",
        "ReadAligner._jobs_to_alignments", "ReadAligner._align_jobs_arrays",
        "ReadAligner._align_jobs_soa", "ReadAligner._align_core_raw"},
    # type_all is the reference's text again (n_workers, worker_pool); the
    # fan-out differs where a worker's failure must end the run, where the
    # device goes to the workers, where their K3 launches come back, and
    # where unpaired chains are packed without their quality caches
    "models/typer": {
        "HLATyper.__init__", "HLATyper._type_locus",
        "HLATyper._setup_pair_ranges", "HLATyper._collect_locus_obs",
        "HLATyper._column_qc", "HLATyper._write_pileup",
        "HLATyper._write_summary_statistics", "KmerCountIndex.build",
        "HLATyper._type_loci_parallel", "_typing_worker",
        "_typing_worker_init", "_pack_optional_chains"},
    # the device and mesh seams; _align_all, _shard_path and
    # _write_reads_per_level are the reference's text
    "models/pipeline": {"run_hla_typing", "_type_and_write", "align_shard",
                        "merge_shards_and_type"},
    # the packers and PackedAlignedPairs are the reference's text; the
    # workers build the port's aligner on a device, take their share of the
    # pointer budget and send their counters back; spawn_safe also passes
    # a main module that has no file to re-run
    "models/parallel_host": {
        "_init_worker", "_align_chunk", "_align_unpaired_chunk",
        "pack_reads", "spawn_safe", "ParallelAligner.__init__",
        "ParallelAligner.align_pairs", "ParallelAligner.align_unpaired"},
    # the device seam and the batched pass over all reads' NW jobs; the
    # backtrace's consumer _score_ops, the gene assignment and the result
    # record are the reference's text
    "models/linear_alts": {
        "LinearALTsTyper.__init__", "LinearALTsTyper.haplotype_likelihoods",
        "LinearALTsTyper.type_diploid", "LinearALTsTyper.estimate_insert",
        "LinearALTsTyper.type_diploid_paired"},
    # the device seam: the two places that score through the NW forward
    "models/asm": {"AssemblyTyper.__init__", "AssemblyTyper._exon_distances",
                   "AssemblyTyper._verify_located_candidate"},
    "cli": {"_regions_from_spec", "_require_graph", "_split_long_reads",
            "action_hla", "main", "action_asm", "action_kir",
            "action_kir_simulation", "action_build_kir_panel"},
}


def _units(path: Path) -> dict[str, str]:
    """Source text of each top-level function, each method, and each class
    without methods."""
    src = path.read_text()
    units = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef):
            units[node.name] = ast.get_source_segment(src, node)
        elif isinstance(node, ast.ClassDef):
            methods = [k for k in node.body if isinstance(k, ast.FunctionDef)]
            if not methods:
                units[node.name] = ast.get_source_segment(src, node)
            for k in methods:
                units[f"{node.name}.{k.name}"] = ast.get_source_segment(src, k)
    return units


@pytest.mark.parametrize("module", sorted(REWRITTEN_UNITS))
def test_rewritten_module_keeps_the_reference_text_elsewhere(module):
    ref = _units(REFERENCE / (module + ".py"))
    port = _units(PORT / (module + ".py"))
    shared = set(ref) & set(port)
    assert len(shared) >= 4, sorted(shared)
    changed = {name for name in shared if ref[name] != port[name]}
    assert changed == REWRITTEN_UNITS[module], sorted(changed)


def test_one_aligner_one_typer_one_type_locus():
    """The aligner and the typer are classes of the port alone, and the
    package holds one _type_locus."""
    for cls in (ReadAligner, HLATyper):
        assert [c.__module__.split(".")[0] for c in cls.__mro__[:-1]] == \
            ["hla_la_tpu_torch"], cls.__mro__
    holders = [p for p in PORT.rglob("*.py")
               if "def _type_locus(" in p.read_text()]
    assert holders == [PORT / "models" / "typer.py"]
    assert (PORT / "models" / "typer.py").read_text().count(
        "def _type_locus(") == 1
    # the typing workers call that one _type_locus on a typer of their own
    from hla_la_tpu_torch.models import typer as port_typer
    import inspect
    assert "typer._type_locus(" in inspect.getsource(
        port_typer._typing_worker)
    assert "_type_locus" not in inspect.getsource(
        HLATyper._type_loci_parallel).replace("_typing_worker", "")


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


@pytest.mark.parametrize("suffix", [".cu", ".cuh", ".h"])
def test_build_digest_follows_sources_and_headers(tmp_path, suffix):
    """An edit to a source or to a header beside it (the NW kernels share
    csrc/banded_nw_row.cuh) gives the library another name, so it is
    rebuilt."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == \
        ["banded_nw_row.cuh"]
    before = _build._digest(csrc)
    assert before == _build._digest(_build.CSRC) == _build._digest()
    target = next(iter(sorted(csrc.glob("*" + suffix))), csrc / ("new" + suffix))
    with open(target, "a") as fh:
        fh.write("// edited\n")
    assert _build._digest(csrc) != before
    assert len({p.name for p in _build._sources(csrc)}) == 3


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
    """The smoke run drives the port alone: it imports the port's CLI, no
    jax and no hla_la_tpu module, at the top or inside a function, and it
    blocks both before anything else is imported, so that an import of
    either from inside the port fails there."""
    names = _imports(REPO / "chip_smoke.py")
    assert "hla_la_tpu_torch.cli" in names
    assert not {n.split(".")[0] for n in names} & FORBIDDEN
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    blocked = [node for node in tree.body if isinstance(node, ast.For)
               and "sys.modules[_blocked] = None" in ast.unparse(node)]
    assert len(blocked) == 1
    assert {c.value for c in blocked[0].iter.elts} == {"jax", "hla_la_tpu"}
    first_port_import = min(
        node.lineno for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom)
        and (node.module or "").startswith("hla_la_tpu_torch"))
    assert blocked[0].lineno < first_port_import


# what runs on the device, or decides that it does
DEVICE_PATH_FILES = ["_build.py", "device.py", "cli.py", "profile_e2e.py",
                     "ops/banded_nw.py", "ops/pair_ll.py", "ops/cuda_nw.py",
                     "ops/cuda_nw_long.py", "ops/cuda_pair.py",
                     "models/pipeline.py", "models/linear_alts.py",
                     "models/parallel_host.py", "parallel/mesh.py"]
DEVICE_CALLS = {"banded_nw_forward_torch", "banded_nw_cuda",
                "banded_nw_long_cuda", "pair_ll_diff_cuda",
                "pair_ll_reduction", "cluster_read_ll", "_run_nw", "_forward",
                "_pair_ll_diff", "library", "build", "resolve", "to_device",
                "run_hla_typing", "run_jobs", "scores", "NWRunner",
                "_read_ll_rows", "_score_jobs", "haplotype_likelihoods",
                "type_diploid", "type_diploid_paired", "_exon_distances",
                "_verify_located_candidate", "type_contigs",
                "align_shard", "merge_shards_and_type", "_type_and_write",
                "_type_loci_parallel", "_typing_worker", "ParallelAligner",
                "ShardedNW", "pair_ll_reduction_sharded",
                "sharded_typing_step", "sharded_align_step", "full_step"}
# KmerIndex.build makes the host's k-mer index; it is no kernel build
HOST_INDEX_CLASSES = {"KmerIndex"}


def test_no_fallback_in_the_device_path():
    """Nothing catches a build or launch failure: the device-path modules
    hold no except clause at all, and in the host layers (whose I/O and
    native-library probes do catch errors) no try statement wraps a call
    into the device path."""
    for rel in DEVICE_PATH_FILES:
        tree = ast.parse((PORT / rel).read_text())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, ast.Try) and n.handlers], rel
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Try) and node.handlers):
                continue
            called = {getattr(c.func, "attr", getattr(c.func, "id", None))
                      for stmt in node.body for c in ast.walk(stmt)
                      if isinstance(c, ast.Call)
                      and getattr(getattr(c.func, "value", None), "id",
                                  None) not in HOST_INDEX_CLASSES}
            assert not called & DEVICE_CALLS, (path, node.lineno)


def test_typers_raise_without_a_card_and_never_take_the_host_forward(
        tmp_path, monkeypatch):
    """The linear-ALT and the assembly typer on a CUDA device with no card
    raise when they are made; neither module imports the host NW forward
    (``banded_nw_forward``, native or numpy): every DP cell goes through
    NWRunner to the device."""
    import numpy as np

    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.asm import AssemblyTyper
    from hla_la_tpu_torch.models.linear_alts import LinearALTsTyper
    from hla_la_tpu_torch.sim import simulate_prg_package

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        LinearALTsTyper({"a": "ACGT" * 30, "b": "TTGCA" * 24}, device="cuda")
    sim = simulate_prg_package(np.random.default_rng(3),
                               backbone_length=1200, n_haplotypes=3)
    pkg_dir = sim.write_package(str(tmp_path / "pkg")).dir
    with pytest.raises(RuntimeError, match="is_available"):
        AssemblyTyper(GraphPackage(pkg_dir), device="cuda")
    for rel in ("models/linear_alts.py", "models/asm.py"):
        tree = ast.parse((PORT / rel).read_text())
        names = {a.name for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) for a in node.names}
        assert "NWRunner" in names, rel
        assert not names & {"banded_nw_forward", "banded_nw_forward_torch",
                            "banded_nw_plain", "nw_forward"}, rel
        assert "nw_forward(" not in (PORT / rel).read_text(), rel
