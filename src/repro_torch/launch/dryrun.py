"""Shape dry-run of every (arch x shape x mesh) pair (port of
``repro.launch.dryrun``): ``python -m repro_torch.launch.dryrun --arch
smollm-360m --shape train_4k --mesh single``, or ``--all``.

The reference lowers and compiles each pair's step with XLA for a TPU
pod mesh faked on 512 host devices.  The port's counterpart of
``jax.jit(step).lower(*specs)`` is the step run on the ``meta`` device:
its inputs are built from ``input_specs`` as ``meta`` tensors, which
carry shapes and dtypes and allocate nothing, and the step traces every
shape through the whole model.  A pair whose shapes do not fit together
fails there.  Needs no card.

Per pair it records into
``results/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json``:
  * ``lower_s``: the seconds to build the spec tree and its ``meta``
    tensors; ``compile_s``: the seconds of the ``meta`` run of the step
    (the names are the reference's, whose two stages these replace);
  * ``memory.argument_size_in_bytes``: one device's bytes of the inputs,
    the sum of their shards under the mesh's sharding rules;
  * ``analytic``: ``launch.costs.analytic_costs`` of the pair;
  * the roofline terms on the card the port runs on (``hw.specs.H100``):
    the analytic flops over ``n_chips`` x its bf16 peak and the analytic
    bytes over ``n_chips`` x its HBM rate.

What the port cannot have, it leaves out instead of inventing: XLA's
``cost`` and raw HLO numbers, a compiled executable's temp and output
bytes, and the collective bytes (torch has no SPMD partitioner that
would insert GSPMD's collectives).  ``collectives`` and
``roofline.collective_s`` are ``null``, each with its reason, and
``dominant`` is taken over the two terms that exist.
``roofline.bytes_per_chip`` is the reference's formula, (argument + temp
bytes) / n_chips, with no temp term.

``--all`` runs every pair of ``ARCH_IDS`` x ``SHAPES`` on both meshes, one
subprocess each, skipping pairs already recorded ``ok`` or ``skipped``
unless ``--force``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.hw.specs import H100
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import mesh_context
from repro_torch.launch.specs import (argument_size_in_bytes, input_specs,
                                      materialize)
from repro_torch.launch.steps import shape_supported, step_for_shape

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "results", "dryrun_torch")

COLLECTIVES_REASON = ("not measured: torch has no SPMD partitioner, so no "
                      "collective is inserted to count")
TEMP_REASON = ("not measured: a meta run allocates nothing and torch "
               "compiles no executable whose temp or output bytes to read")


def model_flops(cfg, shape) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference) reference FLOPs."""
    from repro_torch.launch.costs import model_flops_reference

    return model_flops_reference(cfg, shape)


VARIANTS = {
    "baseline": {},
    "seqpar": {"seq_parallel": True},
    "onehot": {"onehot_embed": True},
    "seqpar_onehot": {"seq_parallel": True, "onehot_embed": True},
    "int8kv": {"kv_dtype": "int8"},
    "qserve": {"quantized_serve": True},
    "qserve_int8kv": {"quantized_serve": True, "kv_dtype": "int8"},
    "ringkv": {"ring_kv": True},
    "ringkv_qserve": {"ring_kv": True, "quantized_serve": True},
    "seqpar_dots": {"seq_parallel": True, "remat_policy": "dots"},
    "seqpar_dots_padvocab": {"seq_parallel": True, "remat_policy": "dots",
                             "pad_vocab_to": 256},
}


def run_pair(arch: str, shape_name: str, mesh_kind: str,
             save: bool = True, variant: str = "baseline") -> dict:
    cfg = get_config(arch)
    if variant != "baseline":
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    shape = SHAPES[shape_name]
    ok, reason = shape_supported(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant,
        "timestamp": time.time(),
    }
    if not ok:
        rec.update({"status": "skipped", "reason": reason})
        if save:
            _save(rec)
        return rec

    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                abstract=True)
    n_chips = mesh.size

    step, _ = step_for_shape(cfg, shape)
    t0 = time.time()
    try:
        with mesh_context(mesh):
            specs = input_specs(cfg, shape, mesh)
            args = materialize(specs, "meta")
            t_lower = time.time() - t0
            step(*args)
            t_compile = time.time() - t0 - t_lower
        mem = {"argument_size_in_bytes": argument_size_in_bytes(specs)}
    except Exception as e:                   # noqa: BLE001
        # A pair that fails is recorded as an error, as in the reference;
        # main() exits non-zero on it.
        rec.update({"status": "error", "error": repr(e),
                    "traceback": traceback.format_exc()[-4000:]})
        if save:
            _save(rec)
        return rec

    from repro_torch.launch.costs import analytic_costs

    ac = analytic_costs(cfg, shape)
    terms = {
        "compute_s": H100.compute_term_s(ac.flops, n_chips),
        "memory_s": H100.memory_term_s(ac.hbm_bytes, n_chips),
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)

    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": mem,
        "memory_reason": {"temp_size_in_bytes": TEMP_REASON,
                          "output_size_in_bytes": TEMP_REASON},
        "collectives": None,
        "collectives_reason": COLLECTIVES_REASON,
        "analytic": {"flops": ac.flops, "hbm_bytes": ac.hbm_bytes,
                     **ac.detail},
        "roofline": {
            **terms,
            "collective_s": None,
            "collective_s_reason": COLLECTIVES_REASON,
            "device": H100.name,
            "dominant": dominant,
            "model_flops": mf,
            "analytic_flops": ac.flops,
            "useful_flops_ratio": mf / ac.flops if ac.flops else None,
            "bytes_per_chip": mem["argument_size_in_bytes"]
            / max(n_chips, 1),
        },
    })
    if save:
        _save(rec)
    return rec


def _save(rec: dict) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = "" if rec.get("variant", "baseline") == "baseline" \
        else f"__{rec['variant']}"
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(RESULTS_DIR, fname), "w") as f:
        json.dump(rec, f, indent=2)


def _already_done(arch, shape, mesh_kind) -> bool:
    fname = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_kind}.json")
    if not os.path.exists(fname):
        return False
    with open(fname) as f:
        return json.load(f).get("status") in ("ok", "skipped")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline",
                    choices=list(VARIANTS))
    ap.add_argument("--all", action="store_true",
                    help="run every pair in subprocesses (resumable)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    if args.all:
        pairs = [(a, s, m) for a in ARCH_IDS for s in SHAPES
                 for m in ("single", "multi")]
        failed = []
        for a, s, m in pairs:
            if not args.force and _already_done(a, s, m):
                print(f"[skip-cached] {a} {s} {m}")
                continue
            print(f"[run] {a} {s} {m}", flush=True)
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", a, "--shape", s, "--mesh", m],
                env={**os.environ},
            )
            if r.returncode != 0:
                failed.append((a, s, m))
        print(f"done; {len(failed)} failures: {failed}")
        return 1 if failed else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    rec = run_pair(args.arch, args.shape, args.mesh, variant=args.variant)
    status = rec["status"]
    if status == "ok":
        rl = rec["roofline"]
        print(f"OK {args.arch} {args.shape} {args.mesh}: "
              f"compute={rl['compute_s']:.3e}s memory={rl['memory_s']:.3e}s "
              f"collective=null dominant={rl['dominant']} "
              f"(lower {rec['lower_s']}s, compile {rec['compile_s']}s)")
        return 0
    if status == "skipped":
        print(f"SKIPPED {args.arch} {args.shape}: {rec['reason']}")
        return 0
    print(f"ERROR {args.arch} {args.shape} {args.mesh}: {rec['error']}")
    print(rec.get("traceback", ""))
    return 2


if __name__ == "__main__":
    sys.exit(main())
