"""Command-line entry points.

`python -m similaritysearchbyrdf_tpu_torch.cli genparams <conf>` mirrors the
reference's only CLI (`object LSH.main`, `LSH.scala:214-225`): generate hash
parameters from a config file and write them to `file.txt`. `fit` builds a
forest from a dense text file and saves it (`storage/persist.save_forest`,
the JAX package's files); `query` loads one and prints a JSON line per
query, as `similaritysearchbyrdf_tpu.cli` does. `--device` names where the
work runs: the first CUDA card by default, `--device cpu` for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def cmd_genparams(args: argparse.Namespace) -> int:
    from .config import from_hocon_file, RDFConfig
    from .models.families import generate_model, save_model_file

    conf = (
        from_hocon_file(args.config) if args.config else RDFConfig()
    ).replace(generate_method="default")
    model = generate_model(conf, device=args.device)
    save_model_file(model, args.output)
    print(f"wrote {model.total_tables * model.chain_length} hash functions "
          f"to {args.output}")
    return 0


def cmd_fit(args: argparse.Namespace) -> int:
    from .config import from_hocon_file, RDFConfig
    from .index.forest import RDFForest
    from .storage.persist import save_forest
    from .vectors import load_dense_file

    conf = from_hocon_file(args.config) if args.config else RDFConfig()
    batch = load_dense_file(args.data, limit=args.limit)
    conf = conf.replace(vector_dim=batch.dim)
    forest = RDFForest(conf, device=args.device).fit(batch)
    save_forest(forest, args.output)
    print(f"fitted {forest.size()} vectors, "
          f"{forest.index_bytes_per_vector():.1f} index bytes/vector → "
          f"{args.output}.npz")
    return 0


def cmd_query(args: argparse.Namespace) -> int:
    from .storage.persist import load_forest
    from .vectors import load_dense_file

    forest = load_forest(args.index, device=args.device)
    queries = load_dense_file(args.queries, limit=args.limit)
    ids, scores = forest.query(queries.values, steps=args.steps, k=args.k)
    for i in range(len(ids)):
        print(json.dumps({
            "query": int(queries.ids[i]),
            "ids": [int(v) for v in ids[i] if v >= 0],
            "scores": [round(float(s), 6) for s, v in zip(scores[i], ids[i]) if v >= 0],
        }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="similaritysearchbyrdf_tpu_torch")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device to run on (default: the first CUDA card; 'cpu')")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("genparams", help="generate hash parameters to a file "
                       "(the reference's LSH.main)", parents=[common])
    g.add_argument("--config", default=None, help="HOCON-style mclab.* config file")
    g.add_argument("--output", default="file.txt")
    g.set_defaults(fn=cmd_genparams)

    f = sub.add_parser("fit", help="build an index from a dense text file",
                       parents=[common])
    f.add_argument("data")
    f.add_argument("--config", default=None)
    f.add_argument("--output", default="index")
    f.add_argument("--limit", type=int, default=None)
    f.set_defaults(fn=cmd_fit)

    q = sub.add_parser("query", help="query a saved index", parents=[common])
    q.add_argument("index")
    q.add_argument("queries")
    q.add_argument("--steps", type=int, default=0)
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--limit", type=int, default=None)
    q.set_defaults(fn=cmd_query)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
