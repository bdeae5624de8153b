"""Hash-family models: parameter generation with the JAX package's numpy draws.

Counterpart of `similaritysearchbyrdf_tpu/models/families.py`. The
parameters come from the same `np.random.default_rng` sequence, so a seed
gives bit-equal arrays in both packages:

  proj[T, C, D]  projection rows of tableNum base chains of chainLength
  perm[T, P, C]  per-(table, permutation) function order
                 (`AngleHashFamily.scala:143-146`)
  b[T, C], w     p-stable offsets and width (`PStableHashFamily.scala:122-143`)

The JAX package attaches hi/lo pack-weight matrices to the model when
`use_pallas_hash` is set; they exist only to do the TPU kernel's bit-pack as
f32 matmuls. The CUDA hash kernel packs with integer shifts from `perm`, so
the port's model carries `perm` alone, whatever that flag says.

A model also round-trips through the reference's text checkpoint
(`save_model_file`, `load_model_file`, `generate_method="fromfile"`), whose
bytes equal the JAX package's for the same model.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from ..config import RDFConfig
from . import transforms

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: the one named, else the first CUDA
    card. With no device named and no CUDA it raises: the port never falls
    back to the CPU quietly. Pass `device="cpu"` to run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class HashModel:
    proj: torch.Tensor           # f32[T, C, D]
    perm: torch.Tensor           # i32[T, P, C]
    b: torch.Tensor              # f32[T, C] (zeros for angle)
    sampling_perm: torch.Tensor  # i32[32]
    family: str = "angle"
    w: int = 4
    type_of_index: str = "original"

    @property
    def table_num(self) -> int:
        return self.proj.shape[0]

    @property
    def chain_length(self) -> int:
        return self.proj.shape[1]

    @property
    def dim(self) -> int:
        return self.proj.shape[2]

    @property
    def permutation_num(self) -> int:
        return self.perm.shape[1]

    @property
    def total_tables(self) -> int:
        return self.table_num * self.permutation_num

    def to(self, device: Device) -> "HashModel":
        return dataclasses.replace(
            self, proj=self.proj.to(device), perm=self.perm.to(device),
            b=self.b.to(device), sampling_perm=self.sampling_perm.to(device),
        )


def _model(proj, perm, b, conf: RDFConfig, family: str, w: int,
           device: Device) -> HashModel:
    device = resolve_device(device)
    return HashModel(
        proj=torch.as_tensor(np.ascontiguousarray(proj), dtype=torch.float32, device=device),
        perm=torch.as_tensor(np.ascontiguousarray(perm), dtype=torch.int32, device=device),
        b=torch.as_tensor(np.ascontiguousarray(b), dtype=torch.float32, device=device),
        sampling_perm=torch.as_tensor(
            transforms.sampling_permutation(conf.sampling_seed), device=device),
        family=family, w=w, type_of_index=conf.type_of_index,
    )


def _unit_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """Random unit vectors (`AngleHashFamily.getNewUnitVector`)."""
    vals = rng.random((n, dim)) * np.where(rng.integers(0, 2, (n, dim)) > 0, 1.0, -1.0)
    return (vals / np.linalg.norm(vals, axis=1, keepdims=True)).astype(np.float32)


def _orthogonal_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """QR-orthogonalized family rows in blocks of `dim`
    (`initOrthogonalUnitVectorHashFamily`)."""
    blocks = []
    remaining = n
    while remaining > 0:
        k = min(remaining, dim)
        blocks.append(np.linalg.qr(rng.random((dim, dim)))[0][:k])
        remaining -= k
    return np.concatenate(blocks, axis=0).astype(np.float32)


def generate_angle_model(conf: RDFConfig, seed: Optional[int] = None,
                         device: Device = None) -> HashModel:
    """Angle (sign-random-projection) family (`AngleHashFamily.pick`)."""
    rng = np.random.default_rng(conf.seed if seed is None else seed)
    t, c, d, p = (conf.table_num, conf.lsh_table.chain_length,
                  conf.vector_dim, conf.permutation_num)
    if conf.generate_by_pulling:
        family = (_orthogonal_rows(rng, conf.family_size, d) if conf.is_orthogonal
                  else _unit_rows(rng, conf.family_size, d))
        proj = family[rng.integers(0, conf.family_size, size=(t, c))]
    else:
        proj = _unit_rows(rng, t * c, d).reshape(t, c, d)
    perm = np.stack(
        [np.stack([rng.permutation(c) for _ in range(p)]) for _ in range(t)]
    )
    return _model(proj, perm, np.zeros((t, c), np.float32), conf, "angle",
                  conf.pstable.w, device)


def generate_pstable_model(conf: RDFConfig, seed: Optional[int] = None,
                           device: Device = None) -> HashModel:
    """p-stable (E2LSH) family (`PStableHashFamily.pick`); chains are
    tableNum only, so permutations are identity."""
    rng = np.random.default_rng(conf.seed if seed is None else seed)
    t, c, d = conf.table_num, conf.lsh_table.chain_length, conf.vector_dim
    ps = conf.pstable
    a = rng.normal(ps.mu, ps.sigma, size=(conf.family_size, d)).astype(np.float32)
    b_family = (rng.random(conf.family_size) * ps.w).astype(np.float32)
    draw = rng.integers(0, conf.family_size, size=(t, c))
    perm = np.broadcast_to(np.arange(c, dtype=np.int32), (t, 1, c))
    return _model(a[draw], perm, b_family[draw], conf, "pStable", ps.w, device)


def generate_model(conf: RDFConfig, seed: Optional[int] = None,
                   device: Device = None) -> HashModel:
    """Family dispatch (`LSH.initHashChains`, `LSH.scala:29-53`), including
    the load-from-file path (`generate_method="fromfile"`,
    `LSH.scala:69-77`): confType "partition" reads
    `partition_family_file_path`, any other `family_file_path`."""
    if conf.generate_method == "fromfile":
        if conf.conf_type == "partition":
            path = conf.partition_family_file_path
            if path is None:
                raise ValueError("generate_method=fromfile with confType=partition "
                                 "requires partition_family_file_path")
        else:
            path = conf.family_file_path
            if path is None:
                raise ValueError("generate_method=fromfile requires family_file_path")
        return load_model_file(path, conf, device)
    if conf.family_name == "angle":
        return generate_angle_model(conf, seed, device)
    if conf.family_name == "pStable":
        return generate_pstable_model(conf, seed, device)
    raise ValueError(f"{conf.family_name!r} is not a valid family name")


# ---------------------------------------------------------------------------
# Hash-function file round trip (the reference's model checkpoint format)
# ---------------------------------------------------------------------------


def _sparse_vector_str(vid: int, values: np.ndarray) -> str:
    """The reference's SparseVector.toString: `(id,size,[i...],[v...])`."""
    nz = np.nonzero(values)[0]
    idx = ",".join(str(int(i)) for i in nz)
    val = ",".join(repr(float(values[i])) for i in nz)
    return f"({vid},{len(values)},[{idx}],[{val}])"


def write_lines(lines: List[str], path: str) -> None:
    """The reference's line layout: every line ends in CR LF."""
    with open(path, "w") as fh:
        fh.write("\r\n".join(lines) + "\r\n")


def save_model_file(model: HashModel, path: str) -> None:
    """Write hash functions in the reference's text format
    (`LSH.outPutTheHashFunctionsIntoFile`, `LSH.scala:173-195`): one function
    per line, chains in table-major order with permutations expanded (each
    saved chain is already permuted); p-stable lines append `;b;w`."""
    proj = model.proj.cpu().numpy()
    perm = model.perm.cpu().numpy()
    b = model.b.cpu().numpy()
    lines: List[str] = []
    for t in range(model.table_num):
        for p in range(model.permutation_num):
            for j in range(model.chain_length):
                f = int(perm[t, p, j])
                line = _sparse_vector_str(len(lines), proj[t, f])
                if model.family != "angle":
                    line += f";{float(b[t, f])!r};{model.w}"
                lines.append(line)
    write_lines(lines, path)


def read_function_rows(path: str) -> List[str]:
    """The non-empty lines of a hash-function file, stripped."""
    with open(path, "r") as fh:
        return [line.strip() for line in fh if line.strip()]


def load_model_file(path: str, conf: RDFConfig, device: Device = None) -> HashModel:
    """Load a hash-function file (angle `(..)` lines or p-stable `(..);b;w`
    lines), every `chainLength` lines one chain
    (`generateTableChainFromFile`, `AngleHashFamily.scala:158-177`,
    `PStableHashFamily.scala:88-108`). Loaded chains become T*P distinct
    tables, each with one identity permutation (P = 1)."""
    from ..vectors import from_string

    c = conf.lsh_table.chain_length
    rows: List[np.ndarray] = []
    bs: List[float] = []
    w = conf.pstable.w
    family = "angle"
    for line in read_function_rows(path):
        if ";" in line:
            family = "pStable"
            vec_s, b_s, w_s = line.split(";")
            b_val, w = float(b_s), int(w_s)
        else:
            vec_s, b_val = line, 0.0
        _, size, idx, val = from_string(vec_s)
        dense = np.zeros(size, dtype=np.float32)
        dense[idx] = val
        rows.append(dense)
        bs.append(b_val)
    if len(rows) % c != 0:
        raise ValueError(f"{path}: {len(rows)} functions not divisible by chainLength {c}")
    t = len(rows) // c
    proj = np.stack(rows).reshape(t, c, -1)
    b = np.asarray(bs, dtype=np.float32).reshape(t, c)
    perm = np.broadcast_to(np.arange(c, dtype=np.int32), (t, 1, c))
    return _model(proj, perm, b, conf, family, w, device)
