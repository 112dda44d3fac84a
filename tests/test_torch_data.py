"""The port's data path against ssl_tpu's on the same files and seeds: path
pairing, transforms, every ported dataset's items, the sampler, masks and the
first loader batches, all exact."""

import os
import random

import cv2
import numpy as np
import pytest
import torch
from scipy.io import savemat

from ssl_tpu.data import data_util as jdu
from ssl_tpu.data import loader as jloader
from ssl_tpu.data import paired_image_dataset as jds
from ssl_tpu.data import transforms as jtf
from ssl_tpu_torch.data import data_util as tdu
from ssl_tpu_torch.data import loader as tloader
from ssl_tpu_torch.data import paired_image_dataset as tds
from ssl_tpu_torch.data import transforms as ttf
from ssl_tpu_torch.data import build_dataset

N_TRAIN, GT, SCALE = 6, 48, 4


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """GT/LQ PNGs (cv2), .mat masks, and a val pair whose LQ sides are not
    multiples of 16; one mask of each other format."""
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.RandomState(0)
    d = {k: os.path.join(root, k) for k in ("gt", "lq", "mask", "vgt", "vlq")}
    for p in d.values():
        os.makedirs(p)
    for i in range(N_TRAIN):
        img = (rng.rand(GT, GT, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d["gt"], f"im{i}.png"), img)
        lq = cv2.resize(img, (GT // SCALE, GT // SCALE), interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(d["lq"], f"im{i}.png"), lq)
        mask = (rng.rand(GT, GT) < 0.3).astype(np.float64)
        if i == 1:
            np.save(os.path.join(d["mask"], f"im{i}.npy"), mask.astype(np.float32))
        elif i == 2:
            cv2.imwrite(os.path.join(d["mask"], f"im{i}.png"), (mask * 255).astype(np.uint8))
        else:
            savemat(os.path.join(d["mask"], f"im{i}.mat"), {"mat": mask})
    for i, (h, w) in enumerate([(12, 20), (9, 14)]):
        img = (rng.rand(h * SCALE + 3, w * SCALE + 1, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d["vgt"], f"v{i}.png"), img)
        cv2.imwrite(os.path.join(d["vlq"], f"v{i}.png"), img[::SCALE, ::SCALE][:h, :w])
    return d


def _train_opt(d, **kw):
    return dict({"name": "t", "type": "PairedImageMaskDataset", "dataroot_gt": d["gt"],
                 "dataroot_lq": d["lq"], "dataroot_gt_mask": d["mask"], "gt_size": 32,
                 "use_hflip": True, "use_rot": True, "phase": "train", "scale": SCALE,
                 "batch_size_per_gpu": 2, "num_worker_per_gpu": 0}, **kw)


def _hwc(v):
    return v.numpy().transpose(1, 2, 0) if torch.is_tensor(v) and v.dim() == 3 else v


def _assert_items_equal(jitem, titem):
    assert set(jitem) == set(titem)
    for k, jv in jitem.items():
        tv = titem[k]
        if isinstance(jv, np.ndarray):
            assert tv.dtype == torch.float32 and tv.dim() == 3
            np.testing.assert_array_equal(_hwc(tv), jv, err_msg=k)
        else:
            assert tv == jv, k


def test_paths_match_jax(folders):
    d = folders
    for suffix, recursive in ((None, False), (".png", False), ((".mat", ".npy"), True)):
        assert list(tdu.scandir(os.path.dirname(d["gt"]), suffix, recursive, True)) == \
            list(jdu.scandir(os.path.dirname(d["gt"]), suffix, recursive, True))
    assert tdu.paired_paths_from_folders([d["lq"], d["gt"]], ["lq", "gt"]) == \
        jdu.paired_paths_from_folders([d["lq"], d["gt"]], ["lq", "gt"])
    assert tdu.paired_paths_with_mask([d["lq"], d["gt"], d["mask"]], ["lq", "gt", "gt_mask"]) == \
        jdu.paired_paths_with_mask([d["lq"], d["gt"], d["mask"]], ["lq", "gt", "gt_mask"])
    assert tdu.paths_from_folder(d["vlq"]) == jdu.paths_from_folder(d["vlq"])
    meta = os.path.join(os.path.dirname(d["gt"]), "meta.txt")
    with open(meta, "w") as f:
        f.write("im3.png (48,48,3)\nim0.png (48,48,3)\n")
    assert tdu.paired_paths_from_meta_info_file([d["lq"], d["gt"]], ["lq", "gt"], meta) == \
        jdu.paired_paths_from_meta_info_file([d["lq"], d["gt"]], ["lq", "gt"], meta)
    lmdb_roots = []
    for name in ("lq.lmdb", "gt.lmdb"):
        p = os.path.join(os.path.dirname(d["gt"]), name)
        os.makedirs(p, exist_ok=True)
        with open(os.path.join(p, "meta_info.txt"), "w") as f:
            f.write("b.png (4,4,3) 1\na.png (4,4,3) 1\n")
        lmdb_roots.append(p)
    assert tdu.paired_paths_from_lmdb(lmdb_roots, ["lq", "gt"]) == \
        jdu.paired_paths_from_lmdb(lmdb_roots, ["lq", "gt"])
    with pytest.raises(ValueError):
        tdu.paired_paths_from_lmdb([d["lq"], d["gt"]], ["lq", "gt"])


def test_transforms_match_jax():
    rng = np.random.RandomState(1)
    gt = rng.rand(40, 44, 3).astype(np.float32)
    lq = rng.rand(10, 11, 3).astype(np.float32)
    mask = rng.rand(40, 44, 1).astype(np.float32)
    np.testing.assert_array_equal(ttf.mod_crop(gt, 3), jtf.mod_crop(gt, 3))
    for seed in range(6):
        outs = []
        for mod in (jtf, ttf):
            r = random.Random(seed)
            a = mod.paired_random_crop(gt, [lq, lq * 2], 16, 4, rng=r)
            b = mod.paired_random_crop_img_mask([gt], lq, mask, 24, 4, rng=r)
            c = mod.augment([gt, lq, mask], True, True, return_status=True, rng=r)
            outs.append((a, b, c, r.random()))
        (ja, jb, jc, jr), (ta, tb, tc, tr) = outs
        assert jr == tr                                  # the same number of draws
        np.testing.assert_array_equal(ta[0], ja[0])
        assert isinstance(ta[1], list) and len(ta[1]) == 2
        for x, y in zip(ta[1] + tb[0] + [tb[1], tb[2]] + tc[0], ja[1] + jb[0] + [jb[1], jb[2]] + jc[0]):
            np.testing.assert_array_equal(x, y)
        assert tc[1] == jc[1]
    with pytest.raises(ValueError, match="Scale mismatches"):
        ttf.paired_random_crop(gt, lq[:5], 16, 4)


@pytest.mark.parametrize("kind", ["mask_train", "paired_train", "paired_val", "paired_memory",
                                  "single"])
def test_dataset_items_match_jax(folders, kind):
    d = folders
    if kind == "mask_train":
        opt = _train_opt(d)
        classes = (jds.PairedImageMaskDataset, tds.PairedImageMaskDataset)
    elif kind == "single":
        opt = {"name": "s", "dataroot_lq": d["vlq"]}
        classes = (jds.SingleImageDataset, tds.SingleImageDataset)
    else:
        opt = {"name": "p", "dataroot_gt": d["vgt" if kind == "paired_val" else "gt"],
               "dataroot_lq": d["vlq" if kind == "paired_val" else "lq"], "gt_size": 32,
               "use_hflip": True, "use_rot": True, "scale": SCALE,
               "phase": "val" if kind == "paired_val" else "train"}
        if kind == "paired_memory":
            store = {os.path.join(d[k], f): open(os.path.join(d[k], f), "rb").read()
                     for k in ("gt", "lq") for f in os.listdir(d[k])}
            opt["io_backend"] = {"type": "memory", "store": store}
        classes = (jds.PairedImageDataset, tds.PairedImageDataset)
    jset, tset = classes[0](dict(opt)), classes[1](dict(opt))
    assert len(jset) == len(tset) > 0
    for i in range(len(jset)):
        random.seed(100 + i)
        jitem = jset[i]
        random.seed(100 + i)
        _assert_items_equal(jitem, tset[i])
    if kind == "paired_val":                             # GT cropped to LQ x scale
        assert tuple(tset[1]["gt"].shape) == (3, 9 * SCALE, 14 * SCALE)
    if kind == "mask_train":
        assert tuple(tset[0]["gt_mask"].shape) == (1, 32, 32)
        assert isinstance(build_dataset(dict(opt)), tds.PairedImageMaskDataset)


def test_load_mask_formats(folders):
    d = folders
    for i, ext in ((0, ".mat"), (1, ".npy"), (2, ".png")):
        path = os.path.join(d["mask"], f"im{i}{ext}")
        got, want = tds.load_mask(path), jds.load_mask(path)
        assert got.dtype == np.float32 and got.shape == (GT, GT)
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0.0, 1.0} and got.mean() > 0.1


@pytest.mark.parametrize("num, world, rank, ratio", [(6, 1, 0, 1), (7, 2, 1, 3), (10, 4, 2, 2)])
def test_enlarged_sampler_matches_jax(num, world, rank, ratio):
    js, ts = jloader.EnlargedSampler(num, world, rank, ratio), tloader.EnlargedSampler(
        num, world, rank, ratio)
    for epoch in (0, 3):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        assert list(ts) == js.indices().tolist()
        assert len(ts) == len(js)


def test_first_loader_batches_match_jax(folders):
    """num_worker_per_gpu 0: the port draws in the main process in the JAX
    thread's order; the same global seed gives the same three batches."""
    opt = _train_opt(folders)
    random.seed(7)
    np.random.seed(7)
    tset = tds.PairedImageMaskDataset(dict(opt))
    tl = tloader.build_dataloader(tset, opt, sampler=tloader.EnlargedSampler(len(tset), 1, 0, 2),
                                  seed=7)
    tl.sampler.set_epoch(1)
    tbatches = [b for _, b in zip(range(3), tl)]
    random.seed(7)
    np.random.seed(7)
    jset = jds.PairedImageMaskDataset(dict(opt))
    jl = jloader.build_dataloader(jset, opt, sampler=jloader.EnlargedSampler(len(jset), 1, 0, 2),
                                  seed=7)
    jl.set_epoch(1)
    jbatches = list(jl)                                  # the whole epoch: the thread ends
    assert len(tl) == len(jl) == N_TRAIN
    for jb, tb in zip(jbatches, tbatches):
        assert tb["lq"].shape == (2, 3, 8, 8) and tb["gt_mask"].shape == (2, 1, 32, 32)
        for k in ("lq", "gt", "gt_mask"):
            np.testing.assert_array_equal(tb[k].numpy().transpose(0, 2, 3, 1), jb[k], err_msg=k)
        assert tb["gt_path"] == jb["gt_path"]
    val = tloader.build_dataloader(tset, {"phase": "val"})
    assert val.batch_size == 1 and val.num_workers == 0


def test_worker_seeds_follow_basicsr():
    tloader.worker_init_fn(1, seed=10)
    a = (random.random(), np.random.rand())
    random.seed(11)
    np.random.seed(11)
    assert a == (random.random(), np.random.rand())
