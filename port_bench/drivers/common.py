"""What the drivers share: the program's config from a configuration
file, seeds, the seeded model, and the comparisons of forward outputs."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.reference.model import Precision
from port_bench.weights import make_weights

# Keys the program derives from others: they cannot be set.
_DERIVED = {"model.input_dim", "model.points_z_sorted", "model.max_vertices"}
SECTIONS = ("data", "model", "train", "eval", "parallel")


def overrides(config: Dict) -> List[str]:
    """The configuration file's every key as `section.key=value`."""
    out = []
    for sec in SECTIONS:
        for k, v in config[sec].items():
            if f"{sec}.{k}" in _DERIVED:
                continue
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            elif isinstance(v, bool):
                v = "true" if v else "false"
            out.append(f"{sec}.{k}={v}")
    return out


def program_config(config: Dict):
    """The program's Config holding the configuration file's values."""
    from wireframe_tpu_torch.config import load_config

    return load_config(None, overrides(config))


def seeds(seed: int, n: int = 4) -> List[int]:
    """n independent 63-bit seeds from the run's --seed (any whole
    number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(x) for x in ss.generate_state(n, dtype=np.uint64) >> 1]


def precision(config: Dict, lower: str = "") -> Precision:
    dt = {"bfloat16": torch.bfloat16,
          "float32": torch.float32}[config["model"]["compute_dtype"]]
    return Precision(dt, lower)


def control_precision(config: Dict) -> str:
    """The nearest precision below the configuration's: fp8 for bf16,
    TF32 for float32 (which runs with TF32 off)."""
    return {"bfloat16": "fp8",
            "float32": "tf32"}[config["model"]["compute_dtype"]]


def build_model(cfg, seed: int, device):
    """(the program's model on `device` with the seeded weights, the
    weights): the weights stay the benchmark's, for the reference."""
    from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  PointCloudToWireframe(cfg.model).state_dict().items()}
    weights = make_weights(shapes, seed, device)
    with torch.device(device):
        model = PointCloudToWireframe(cfg.model)
    model.load_state_dict(weights, strict=True)
    return model, weights


FORWARD_KEYS = ("vertices", "edge_probs", "actual_vertex_counts",
                "existence_probabilities")


def forward_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor],
                 rows: int) -> Dict[str, float]:
    """Widest gaps between the program's forward outputs (first `rows`
    rows of its arrays) and the reference's:
    - vertex_gap: of any slot's coordinate (normalised frame);
    - exist_gap: of any slot's existence probability;
    - edge_gap: of any pair's probability, the reference's sigmoid taken
      under the program's own pair mask (both slots' existence > 0.5), so
      a slot whose existence sits at the threshold does not count twice;
    - count_self_gap: a check of the program against itself, not against
      the reference: slots whose live state (existence > 0.5) disagrees
      with the program's reported count (exist_gap holds the existence
      probabilities themselves to the reference)."""
    pv = prog["vertices"][:rows].astype(np.float64)
    pe = prog["existence_probabilities"][:rows].astype(np.float64)
    pp = prog["edge_probs"][:rows].astype(np.float64)
    rv = ref["vertices"].double().cpu().numpy()
    re_ = ref["existence_probabilities"].double().cpu().numpy()
    rs = torch.sigmoid(ref["edge_logits"].double()).cpu().numpy()
    v = pv.shape[1]
    i, j = np.triu_indices(v, k=1)
    live = pe > 0.5
    mask = live[:, i] & live[:, j]
    counts = prog["actual_vertex_counts"][:rows].astype(np.int64)
    return {"vertex_gap": float(np.abs(pv - rv).max()),
            "exist_gap": float(np.abs(pe - re_).max()),
            "edge_gap": float(np.abs(pp - rs * mask).max()),
            "count_self_gap": float(np.abs(live.sum(-1) - counts).max())}


def merge_max(parts: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in parts:
        for k, x in p.items():
            out[k] = max(out.get(k, -np.inf), x)
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Tuple[float, float]]:
    """{name: (number, limit)} of the numbers the cell's limits file names
    (each must exist); the other numbers are not compared."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits for numbers that do not exist: {missing}")
    return {k: (float(numbers[k]), float(limits[k])) for k in limits}


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
