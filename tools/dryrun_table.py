"""Print the dry run's serve cells as a markdown table, a tree's records
beside another's.

Reads the records that ``python -m repro_torch.launch.dryrun --arch A
--shape S --both-meshes --force`` and then ``... --roofline`` write
under a tree's ``build/results_torch`` (``dryrun/<cell>.json`` and
``roofline/<arch>__<shape>__16x16.json``) and prints, for each arch and
shape, on both meshes:

* GiB a device: the step's arguments plus its temp peak;
* the FLOPs ratio: ``flops_per_device`` x the mesh's devices over the
  cell's global FLOPs (``exact_flops``, ``hlo_flops_global`` of the
  roofline record);
* collective GiB a device on 16 x 16, by kind, and the roofline's
  bottleneck on 16 x 16.

With ``--parent DIR``, each figure is followed by the parent tree's in
parentheses.

Usage:
  python tools/dryrun_table.py [--results build/results_torch] \\
      [--parent OTHER/build/results_torch] [--archs A,B] [--shapes S,T]
"""

import argparse
import json
from pathlib import Path

ARCHS = ("olmo-1b", "stablelm-1.6b", "internlm2-20b", "gemma2-2b",
         "paligemma-3b")
SHAPES = ("prefill_32k", "decode_32k")
GIB = 2 ** 30


def cell(root: Path, arch: str, shape: str) -> dict:
    """The figures of one arch and shape under ``root``."""
    out = {}
    roof = json.loads((root / "roofline" /
                       f"{arch}__{shape}__16x16.json").read_text())
    exact = roof["hlo_flops_global"]
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = json.loads((root / "dryrun" /
                          f"{arch}__{shape}__{mesh}.json").read_text())
        if not rec.get("ok"):
            raise SystemExit(f"{rec['cell']}: {rec.get('error')}")
        out[mesh] = {
            "gib": (rec["argument_size_in_bytes"]
                    + rec["temp_size_in_bytes"]) / GIB,
            "ratio": rec["flops_per_device"] * rec["n_devices"] / exact,
            "coll": {k: v / GIB for k, v in rec["collective_bytes"].items()
                     if v},
        }
    out["bottleneck"] = roof["bottleneck"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="build/results_torch")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)

    def fig(new, old, fmt):
        return fmt.format(new) + ("" if old is None else
                                  " (" + fmt.format(old) + ")")

    print("| arch | shape | GiB 16x16 | GiB 2x16x16 | FLOPs ratio 16x16 | "
          "FLOPs ratio 2x16x16 | coll GiB 16x16 by kind | bottleneck |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in args.archs.split(","):
        for shape in args.shapes.split(","):
            new = cell(Path(args.results), arch, shape)
            old = (cell(Path(args.parent), arch, shape) if args.parent
                   else None)

            def pick(mesh, key, src):
                return None if src is None else src[mesh][key]

            coll = ", ".join(
                f"{k} " + fig(v, pick("pod16x16", "coll", old).get(k, 0.0)
                              if old else None, "{:.3f}")
                for k, v in new["pod16x16"]["coll"].items()
                if k != "total")
            total = fig(new["pod16x16"]["coll"].get("total", 0.0),
                        pick("pod16x16", "coll", old).get("total", 0.0)
                        if old else None, "{:.3f}")
            print(f"| {arch} | {shape} | "
                  f"{fig(new['pod16x16']['gib'], pick('pod16x16', 'gib', old), '{:.2f}')} | "
                  f"{fig(new['pod2x16x16']['gib'], pick('pod2x16x16', 'gib', old), '{:.2f}')} | "
                  f"{fig(new['pod16x16']['ratio'], pick('pod16x16', 'ratio', old), '{:.4f}')} | "
                  f"{fig(new['pod2x16x16']['ratio'], pick('pod2x16x16', 'ratio', old), '{:.4f}')} | "
                  f"total {total}: {coll} | "
                  f"{fig(new['bottleneck'], old and old['bottleneck'], '{}')} |")


if __name__ == "__main__":
    main()
