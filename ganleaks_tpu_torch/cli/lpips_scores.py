"""2AFC / JND perceptual-score CLI on the GPU (port of
``ganleaks_tpu.cli.lpips_scores``; DistModel evaluation surface,
``lpips_pytorch/models/dist_model.py:253-330``):

    python -m ganleaks_tpu_torch.cli.lpips_scores \\
        data_dir=triplets.npz mode=2afc model=net-lin net=alex
    python -m ganleaks_tpu_torch.cli.lpips_scores \\
        data_dir=data/jnd/val/cnn mode=jnd model=l2 colorspace=Lab

Accepts one .npz holding the arrays (numpy only) or the original LPIPS
dataset directory layout (PNGs through Pillow, loaded lazily; see
``config.ScoresConfig``). 'net-lin' and 'net' run on the GPU;
``--device cpu`` (or ``main(argv, device="cpu")``) runs them on the CPU.
'l2' and 'ssim' run on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import ScoresConfig
from ganleaks_tpu_torch.ops.lpips.scoring import (make_pair_dist_fn,
                                           score_2afc, score_jnd)


def _load_arrays(cfg: ScoresConfig, names: tuple) -> dict:
    """names = image dirs + one .npy label dir (last entry)."""
    if cfg.data_dir.endswith(".npz"):
        with np.load(cfg.data_dir) as z:
            out = {n: z[n] for n in names}
    else:
        from ganleaks_tpu_torch.io.images import (get_filepaths_from_dir,
                                           load_image_dir)
        out = {}
        for n in names[:-1]:
            out[n] = load_image_dir(os.path.join(cfg.data_dir, n),
                                    resolution=cfg.resolution,
                                    limit=cfg.limit)
        labels = get_filepaths_from_dir(os.path.join(cfg.data_dir,
                                              names[-1]), "npy")
        if cfg.limit:
            labels = labels[:cfg.limit]
        out[names[-1]] = np.asarray([np.load(p).reshape(()) for p in labels],
                                    np.float64)
    n = min(len(out[k]) for k in names)
    if cfg.limit:
        n = min(n, cfg.limit)
    return {k: np.asarray(v)[:n] for k, v in out.items()}


def main(argv=None, device=None) -> dict:
    cfg, device = parse_config(ScoresConfig, argv,
                               "2AFC/JND perceptual-metric scores",
                               device)
    dist = make_pair_dist_fn(cfg.model, net=cfg.net,
                             colorspace=cfg.colorspace, weights=cfg.weights,
                             device=device)
    b = cfg.batch_size

    def batched(a0, a1):
        return np.concatenate([dist(a0[i:i + b], a1[i:i + b])
                               for i in range(0, len(a0), b)])

    if cfg.mode == "2afc":
        d = _load_arrays(cfg, ("ref", "p0", "p1", "judge"))
        score = score_2afc(batched(d["ref"], d["p0"]),
                           batched(d["ref"], d["p1"]), d["judge"])
        result = {"mode": "2afc", "score": score, "n": len(d["judge"])}
    elif cfg.mode == "jnd":
        d = _load_arrays(cfg, ("p0", "p1", "same"))
        score = score_jnd(batched(d["p0"], d["p1"]), d["same"])
        result = {"mode": "jnd", "score": score, "n": len(d["same"])}
    else:
        raise ValueError(f"unknown mode {cfg.mode!r} (2afc | jnd)")
    result.update(model=cfg.model, net=cfg.net)
    print(json.dumps(result))
    if cfg.out_json:
        with open(cfg.out_json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
