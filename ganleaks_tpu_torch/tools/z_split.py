"""CelebA member / non-member split (port of ``ganleaks_tpu.tools.z_split``;
reference ``z_split.py``).

Identities with exactly ``num_same_id`` images form the private (member)
pool; identities with fewer form the public (non-member) pool
(``z_split.py:41-43``). ``num_images / 3`` images are drawn from each
pool. Members are center-cropped (178x218 -> 128x128 at cx=89, cy=121) and
written to the training dir (with a random-crop ``_a1`` and a
horizontal-flip ``_a2`` augmentation) and to the positive-query dir;
non-members go cropped to the negative dir (``z_split.py:82-131``). Each
output dir also gets its set packed as ``_packed_{train,pos,neg}.npy``,
row i the i-th PNG in sorted filename order.

Host work, as in the JAX package: no device. The sources (JPEG) are read
by a lazily imported Pillow on a pool of threads; the PNGs are written in
batches on the port's codec threads (``io/native``), whose pixels equal
Pillow's (the file bytes differ: ROADMAP C). The random crops draw from
``np.random.default_rng(seed)`` member by member in the JAX order, so
every file and pack equals the JAX package's pixel for pixel.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ganleaks_tpu_torch.config import SplitConfig
from ganleaks_tpu_torch.io.native import save_png_batch_native

CHUNK = 512  # sources decoded, cropped and written per batch


def read_identity_annotations(path: str) -> dict[str, list[str]]:
    """``{identity: [filename...]}`` (``z_split.py:34-38``).

    Lines are ``<identity> <filename>``: the reference groups by the FIRST
    token (``len(diz[i]) == num_same_id``, ``z_split.py:41-53``). The
    official ``identity_CelebA.txt`` is ``<filename> <identity>``; a first
    token that looks like a filename raises instead of grouping by file
    names into empty pools."""
    diz: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            annotation, identity = line.strip().split()
            if not diz and annotation.lower().endswith(
                    (".jpg", ".jpeg", ".png")):
                raise ValueError(
                    f"{path}: first token {annotation!r} looks like a "
                    f"filename — this tool (like the reference, "
                    f"z_split.py:34-38) expects '<identity> <filename>' "
                    f"lines; swap the columns of the standard CelebA "
                    f"identity file before splitting")
            diz.setdefault(annotation, []).append(identity)
    return diz


def select_images(diz: dict[str, list[str]], num_images: int,
                  num_same_id: int) -> tuple[list[str], list[str]]:
    """Private / public image lists (``z_split.py:41-66``)."""
    private_ids = [i for i in diz if len(diz[i]) == num_same_id]
    public_ids = [i for i in diz if len(diz[i]) < num_same_id]
    if not private_ids:
        raise ValueError(
            f"no identity has exactly num_same_id={num_same_id} images — "
            f"empty member pool (identity counts range "
            f"{min(map(len, diz.values()))}..{max(map(len, diz.values()))}"
            f" over {len(diz)} identities); check the annotation file's "
            f"column order and num_same_id")
    assert not any(a in private_ids for a in public_ids), \
        "The two lists are not disjoint!"
    assert num_images % 30 == 0, (
        "num_images must be divisible by 30!, either 510, 1020, 2040, "
        "10002, 20001")
    considered = num_images // 3

    def take(ids):
        out: list[str] = []
        for ident in ids:
            if len(out) >= considered:
                break
            room = considered - len(out)
            out += diz[ident] if room > len(diz[ident]) else \
                diz[ident][:room]
        return out

    private_images = take(private_ids)
    public_images = take(public_ids)
    assert not any(img in private_images for img in public_images), \
        "The two lists are not disjoint!"
    return private_images, public_images


def center_crop_128(img: np.ndarray, cx: int = 89,
                    cy: int = 121) -> np.ndarray:
    assert img.shape == (218, 178, 3)
    return img[cy - 64: cy + 64, cx - 64: cx + 64]


def random_crop(img: np.ndarray, rng: np.random.Generator,
                crop_size=(128, 128)) -> np.ndarray:
    """(``z_split.py:125-131``; the reference samples x from the height
    range and y from the width range — replicated)."""
    w, h = img.shape[:2]
    x = rng.integers(0, h - crop_size[0])
    y = rng.integers(0, w - crop_size[1])
    return img[y:y + crop_size[0], x:x + crop_size[1]]


def read_rgb(path: str) -> np.ndarray:
    """A source image as an (H, W, 3) uint8 array, through Pillow."""
    import PIL.Image
    with PIL.Image.open(path) as im:
        return np.asarray(im)


def _sorted_slots(names: list[str]) -> np.ndarray:
    """Row of each name in the sorted-filename pack."""
    slots = np.empty(len(names), np.int64)
    slots[np.argsort(np.array(names), kind="stable")] = np.arange(len(names))
    return slots


def _split_set(cfg: SplitConfig, images: list[str], rng, pool,
               members: bool) -> dict[str, np.ndarray]:
    """Crop ``images`` (members also ``_a1`` / ``_a2`` into the training
    dir) chunk by chunk; returns the packs, rows in sorted-filename
    order."""
    ids = [name.split(".")[0] for name in images]
    if members:
        out = {"train": (cfg.output_dir0,
                         [i + s for i in ids for s in ("", "_a1", "_a2")]),
               "pos": (cfg.output_dir1, ids)}
    else:
        out = {"neg": (cfg.output_dir2, ids)}
    packs = {k: np.empty((len(names), 128, 128, 3), np.uint8)
             for k, (_d, names) in out.items()}
    slots = {k: _sorted_slots(names) for k, (_d, names) in out.items()}
    for lo in range(0, len(images), CHUNK):
        hi = min(lo + CHUNK, len(images))
        raw = list(pool.map(read_rgb, [os.path.join(cfg.input_dir, n)
                                       for n in images[lo:hi]]))
        crops = np.stack([center_crop_128(r) for r in raw])
        if members:
            # draw order: x then y per member, in list order (the JAX loop)
            a1 = np.stack([random_crop(r, rng) for r in raw])
            train = np.stack([crops, a1, crops[:, :, ::-1]], 1).reshape(
                -1, 128, 128, 3)
            written = {"pos": (crops, slice(lo, hi)),
                       "train": (train, slice(3 * lo, 3 * hi))}
        else:
            written = {"neg": (crops, slice(lo, hi))}
        for k, (arr, rows) in written.items():
            d, names = out[k]
            save_png_batch_native(arr, [os.path.join(d, n + ".png")
                                        for n in names[rows]])
            packs[k][slots[k][rows]] = arr
    return packs


def run_split(cfg: SplitConfig) -> dict[str, int]:
    """Split, write the three directories (cleared first) and their packs;
    returns the member and non-member counts."""
    diz = read_identity_annotations(cfg.identity_annotations)
    private_images, public_images = select_images(diz, cfg.num_images,
                                                  cfg.num_same_id)
    for d in (cfg.output_dir0, cfg.output_dir1, cfg.output_dir2):
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    with ThreadPoolExecutor(min(16, 2 * (os.cpu_count() or 1))) as pool:
        packs = _split_set(cfg, private_images, rng, pool, members=True)
        packs.update(_split_set(cfg, public_images, rng, pool,
                                members=False))
    for name, d in (("train", cfg.output_dir0), ("pos", cfg.output_dir1),
                    ("neg", cfg.output_dir2)):
        if len(packs[name]):
            np.save(os.path.join(d, f"_packed_{name}.npy"), packs[name])
    return {"members": len(private_images),
            "non_members": len(public_images)}
