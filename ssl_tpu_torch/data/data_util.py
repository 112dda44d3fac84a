"""Path-pairing helpers (reference: data/data_util.py).

Counterpart of ``ssl_tpu/data/data_util.py:8-102``: the same pairs in the
same order."""

from __future__ import annotations

import os


def scandir(dir_path, suffix=None, recursive=False, full_path=False):
    """Yield file paths under dir_path (reference utils/misc.py:52)."""
    for entry in sorted(os.listdir(dir_path)):
        full = os.path.join(dir_path, entry)
        if os.path.isfile(full):
            rel = full if full_path else entry
            if suffix is None or rel.endswith(tuple(suffix) if isinstance(suffix, (list, tuple)) else suffix):
                yield rel
        elif recursive and os.path.isdir(full):
            for sub in scandir(full, suffix, recursive, full_path=False):
                yield sub if not full_path else os.path.join(full, sub)


def paired_paths_from_folders(folders, keys, filename_tmpl="{}"):
    """Pair files from [input_folder, gt_folder] by basename (reference
    data_util.py paired_paths_from_folder)."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError(f"two folders and two keys expected, got {folders}, {keys}")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    if len(input_paths) != len(gt_paths):
        raise ValueError(f"{input_key} and {gt_key} datasets have different number of images: "
                         f"{len(input_paths)}, {len(gt_paths)}.")
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = os.path.splitext(os.path.basename(gt_path))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        input_path = os.path.join(input_folder, input_name)
        if input_name not in input_paths:
            raise ValueError(f"{input_name} is not in {input_key}_paths.")
        paths.append({f"{input_key}_path": input_path,
                      f"{gt_key}_path": os.path.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file, filename_tmpl="{}"):
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, "r") as f:
        gt_names = [line.strip().split(" ")[0] for line in f if line.strip()]
    paths = []
    for gt_name in gt_names:
        basename, ext = os.path.splitext(os.path.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({f"{input_key}_path": os.path.join(input_folder, input_name),
                      f"{gt_key}_path": os.path.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_lmdb(folders, keys):
    """Both roots are .lmdb directories; item keys come from each
    meta_info.txt (lines '<name>.png (h,w,c) <compress_level>'), stored
    without extension.  Reads no lmdb itself: the file client opens the
    databases."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (str(input_folder).endswith(".lmdb") and str(gt_folder).endswith(".lmdb")):
        raise ValueError(
            f"{input_key} folder and {gt_key} folder should both in lmdb "
            f"formats. But received {input_key}: {input_folder}; "
            f"{gt_key}: {gt_folder}")

    def read_keys(folder):
        with open(os.path.join(folder, "meta_info.txt")) as f:
            return {line.split(".")[0] for line in f if line.strip()}

    input_set, gt_set = read_keys(input_folder), read_keys(gt_folder)
    if input_set != gt_set:
        raise ValueError(f"Keys in {input_key}_folder and {gt_key}_folder "
                         "are different.")
    return [{f"{input_key}_path": k, f"{gt_key}_path": k}
            for k in sorted(gt_set)]


def paths_from_folder(folder):
    return [os.path.join(folder, p) for p in scandir(folder)]


def paired_paths_with_mask(folders, keys, filename_tmpl="{}", mask_ext=".mat"):
    """Triplet pairing: LQ + GT + per-GT edge-mask file (reference
    paired_image_mask_dataset.py:31-46 pairs via identical basenames)."""
    if len(folders) != 3 or len(keys) != 3:
        raise ValueError(f"three folders and three keys expected, got {folders}, {keys}")
    input_folder, gt_folder, mask_folder = folders
    input_key, gt_key, mask_key = keys
    pairs = paired_paths_from_folders([input_folder, gt_folder], [input_key, gt_key], filename_tmpl)
    for d in pairs:
        basename = os.path.splitext(os.path.basename(d[f"{gt_key}_path"]))[0]
        for ext in (mask_ext, ".mat", ".png", ".npy"):
            cand = os.path.join(mask_folder, basename + ext)
            if os.path.exists(cand):
                d[f"{mask_key}_path"] = cand
                break
        else:
            raise FileNotFoundError(f"no mask found for {basename} in {mask_folder}")
    return pairs
