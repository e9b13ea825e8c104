"""soak.py's twin (``soak_torch.py``) on the CPU, and held to soak.py's
source text.

One seed of each of the ten trial kinds runs on the CPU (``run(1, seed,
mode, "cpu")``), and seeds 1000-1003 of mode ``hla`` cover its four input
modes (BAM, CRAM, FASTQ pair, long-read FASTQU): the thirteen trials that
chip_smoke runs on the card.  The twin is soak.py's text with its imports
renamed to the port's and the edits listed in SOAK_EDITS, nothing else, so
the two cannot drift apart unseen."""

from pathlib import Path

import pytest
import torch

import soak_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
RENAMED = ("from hla_la_tpu.", "from hla_la_tpu_torch.")
# (soak.py's text, the twin's), applied before RENAMED
SOAK_EDITS = [
    ('Any crash or wrong call = bug."""',
     'Any crash or wrong call = bug.\n'
     '\n'
     'The twin of soak.py for the PyTorch/CUDA port: the same trials, with '
     'the\n'
     "port's CLI, simulators and typers, on the device that run() is given "
     "(the\n"
     'card unless "cpu"; no fallback).\n'
     '\n'
     '    python3 soak_torch.py [n] [start] [mode] [--device cuda|cpu]"""'),
    ('import jax\n\njax.config.update("jax_platforms", "cpu")\n\n'
     'from hla_la_tpu.cli import main\n',
     '\nfrom hla_la_tpu_torch import cli\n'),
    ('from hla_la_tpu.sim.read_sim import ReadSimulator, revcomp\n',
     'from hla_la_tpu.sim.read_sim import ReadSimulator, revcomp\n'
     '\n'
     'DEVICE = "cuda"     # where the trials run; run() sets it\n'
     '\n'
     '\n'
     'def main(argv: list) -> int:\n'
     '    """The port\'s CLI on DEVICE."""\n'
     '    return cli.main([*argv, "--device", DEVICE])\n'),
    ('    typer = AssemblyTyper(pkg)\n',
     '    typer = AssemblyTyper(pkg, device=DEVICE)\n'),
    ('    n_pairs, n_un = remap_and_reduce(bam, GraphPackage(pkg_dir), out)\n',
     '    n_pairs, n_un = remap_and_reduce(bam, GraphPackage(pkg_dir), out,\n'
     '                                     device=DEVICE)\n'),
    ('def run(n: int, start: int, mode: str = "hla") -> int:\n',
     'def run(n: int, start: int, mode: str = "hla", device: str = "cuda") '
     '-> int:\n'
     '    global DEVICE\n'
     '    from hla_la_tpu_torch.device import resolve\n'
     '    DEVICE = resolve(device).type      # raises here without the '
     'device\n'),
    ('if __name__ == "__main__":\n'
     '    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20\n'
     '    start = int(sys.argv[2]) if len(sys.argv) > 2 else 1000\n'
     '    mode = sys.argv[3] if len(sys.argv) > 3 else "hla"\n'
     '    sys.exit(1 if run(n, start, mode) else 0)\n',
     'def soak_main(argv=None) -> int:\n'
     '    """The command line: the card\'s line first, the trials\' lines, '
     'then\n'
     '    one JSON line."""\n'
     '    import argparse\n'
     '    import json\n'
     '    from hla_la_tpu_torch.bench_common import card_line\n'
     '    ap = argparse.ArgumentParser(description="randomized soak of the '
     'CLI")\n'
     '    ap.add_argument("n", type=int, nargs="?", default=20)\n'
     '    ap.add_argument("start", type=int, nargs="?", default=1000)\n'
     '    ap.add_argument("mode", nargs="?", default="hla")\n'
     '    ap.add_argument("--device", default="cuda", choices=("cuda", '
     '"cpu"))\n'
     '    args = ap.parse_args(argv)\n'
     '    card = card_line(args.device)\n'
     '    print(card, flush=True)\n'
     '    fails = run(args.n, args.start, args.mode, args.device)\n'
     '    print(json.dumps({"mode": args.mode, "seeds": [args.start,\n'
     '                      args.start + args.n - 1], "trials": args.n,\n'
     '                      "fails": fails, "device": args.device, "card": '
     'card}))\n'
     '    return 1 if fails else 0\n'
     '\n'
     '\n'
     'if __name__ == "__main__":\n'
     '    sys.exit(soak_main())\n'),
]
# the trials chip_smoke runs on the card: 1000-1003 of mode hla, then 1000
# of every other mode
TRIALS = [("hla", seed) for seed in range(1000, 1004)] + [
    (mode, 1000) for mode in ("kir", "asm", "shard", "decoy", "validate",
                              "heldout", "recomb", "remap", "corrupt")]


def test_soak_torch_is_soak_py_up_to_the_listed_edits():
    text = (REPO / "soak.py").read_text()
    for old, new in SOAK_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    text = text.replace(*RENAMED)
    assert text == (REPO / "soak_torch.py").read_text()


@pytest.mark.parametrize("mode,seed", TRIALS)
def test_soak_trial_on_the_cpu(mode, seed, capsys):
    assert soak_torch.run(1, seed, mode, "cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"seed {seed}: OK (")
    if mode == "hla":
        assert line.endswith(f"({['bam', 'cram', 'fastq', 'long'][seed % 4]})")
