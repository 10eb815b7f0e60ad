"""A/B timing of versions of swtpu_torch/csrc/sw_wave.cu on one card.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 wave_ab.py parent=old.cu:0 new=swtpu_torch/csrc/sw_wave.cu:1

Each argument is NAME=PATH:FLAGS, FLAGS being the number of int flags the
version's C entry points take between the gaps and the device (0 before the
band-carry hand-off, 1 since).  Every version is compiled with the
package's nvcc flags and timed in turns (versions in order, then in reverse)
on P01008's launches against the SwissProt-shaped database of chip_smoke.py:
the 27 fused launches, linear (gap 2) and affine (10, 2), and, for versions
with a hand-off flag, the 108 launches of a composed search (rungs 8, 4, 2,
1).  Prints each version's registers and milliseconds a search (CUDA events,
five searches after one to warm).  Versions are compared within one run only.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import _build

    out_dir = _build.BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    versions = {}
    for arg in argv:
        name, spec = arg.split("=", 1)
        path, flags = spec.rsplit(":", 1)
        versions[name] = (Path(path), int(flags))
    procs = {name: subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(path)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (path, _) in versions.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {versions[name][0]}:\n{log}")
        print(name, "registers", [int(w.split()[0]) for w in log.split("Used ")[1:]], flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        n_flags = versions[name][1]
        lib.sw_wave_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (7 + n_flags) + [ctypes.c_void_p]
        lib.sw_wave_affine_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (8 + n_flags) + [ctypes.c_void_p]
        libs[name] = lib

    db = synth.synth_database(559_228, seed=0)
    engine = SearchEngine(SWConfig(), device="cuda")
    groups = engine._resident_packed(db).wave_groups
    profile = engine._profile(parse_query(ROOT / "tests" / "data" / "queries" / "P01008.fasta"))
    n_bands = profile.shape[0] // 32
    where = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    # A carry and an output a bucket, sized for the affine mode's two planes.
    bufs = [(torch.zeros(2 * (g.stack.shape[0] - 32) * g.lanes, dtype=torch.int32, device="cuda"),
             torch.empty(g.lanes * g.n_segs, dtype=torch.int32, device="cuda")) for g in groups]

    def launches(name, affine, hand_off):
        lib, n_flags = libs[name], versions[name][1]
        rungs = SearchEngine._compose_groups(n_bands) if hand_off else (n_bands,)
        flags = (int(hand_off),) * n_flags
        band = 0
        for rung in rungs:
            part = profile[band * 32 :].data_ptr()
            band += rung
            for g, (carry, out) in zip(groups, bufs):
                args = (part, g.stack.data_ptr(), carry.data_ptr(), out.data_ptr(), 1, rung, g.lanes, g.n_segs, g.seg_cols)
                rc = (lib.sw_wave_affine_launch(*args, 10, 2, *flags, *where) if affine
                      else lib.sw_wave_launch(*args, 2, *flags, *where))
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

    def ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    order = list(versions) + list(reversed(versions))
    times = {}
    for affine in (False, True):
        gaps = "affine 10/2" if affine else "linear 2"
        for hand_off in (False, True):
            for name in order:
                if hand_off and not versions[name][1]:
                    continue
                key = f"{'composed (108 hand-off launches)' if hand_off else 'fused (27 launches)'} {gaps} {name}"
                times.setdefault(key, []).append(ms(lambda: launches(name, affine, hand_off)))
    for key, values in times.items():
        print(key, "ms:", [round(v, 3) for v in values], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
