"""Scene-semantic-segmentation extraction for real images.

The port's copy of ``multiverse_tpu/data/scene_extract.py``, with one
difference: the SegFormer backend runs its model on the device the
caller names (``cuda`` by default in ``mvt-torch-extract-scene-seg``);
on ``cpu`` it gives the JAX package's backend's bytes.

reference: SimAug/code/extract_scene_seg.py — runs a DeepLab-v3 ADE20k
frozen graph (513-pixel input, `ImageTensor` → `SemanticPredictions`)
over frame jpgs and saves downsampled class maps as npys.

This rebuild is backend-pluggable because the bare image ships no
TensorFlow: `segment_images` accepts any callable
`image_rgb [H, W, 3] uint8 -> class_map [H, W] int`, and two concrete
backends are provided — the original TF frozen graph (when tensorflow
is importable) and a torch/transformers SegFormer-ADE20k model (when
its weights are available locally).  Everything around the model
(resize, save layout, job sharding) is backend-independent and tested
with a fake segmenter.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List

import numpy as np

Segmenter = Callable[[np.ndarray], np.ndarray]


def resize_seg_map(seg: np.ndarray, down_rate: float,
                   keep_full: bool = False) -> np.ndarray:
    """Nearest-neighbor downsample (reference:
    extract_scene_seg.py:43-53; PIL there, pure numpy here)."""
    h, w = seg.shape
    if keep_full:
        new_w, new_h = 512, 288
    else:
        new_w, new_h = int(w / down_rate), int(h / down_rate)
    ys = (np.arange(new_h) * (h / new_h)).astype(np.int64)
    xs = (np.arange(new_w) * (w / new_w)).astype(np.int64)
    return seg[ys[:, None], xs[None, :]].astype(np.uint8)


def make_tf_deeplab_segmenter(model_path: str,
                              input_size: int = 513) -> Segmenter:
    """DeepLab frozen-graph backend (reference:
    extract_scene_seg.py:60-91).  Requires tensorflow."""
    import tensorflow as tf

    graph = tf.Graph()
    with graph.as_default():
        gd = tf.compat.v1.GraphDef()
        with tf.io.gfile.GFile(model_path, "rb") as f:
            gd.ParseFromString(f.read())
        tf.import_graph_def(gd, name="")
    sess = tf.compat.v1.Session(graph=graph)
    inp = graph.get_tensor_by_name("ImageTensor:0")
    out = graph.get_tensor_by_name("SemanticPredictions:0")

    def segment(img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        scale = input_size / max(h, w)
        import cv2

        small = cv2.resize(img, (int(w * scale), int(h * scale)))
        pred = sess.run(out, feed_dict={inp: small[None]})[0]
        return cv2.resize(pred.astype(np.uint8), (w, h),
                          interpolation=cv2.INTER_NEAREST)

    return segment


def make_segformer_segmenter(
    model_name_or_path: str = "nvidia/segformer-b0-finetuned-ade-512-512",
    device: str = "cuda",
) -> Segmenter:
    """torch/transformers SegFormer-ADE20k backend (weights must be
    available locally — this environment has no network egress).  The
    model runs on ``device``; the class map comes back to the host.
    Note ADE20k ids here are 0-based; add 1 to match DeepLab's 1-based
    ids used by the reference's id2name maps."""
    import torch
    from transformers import (
        SegformerForSemanticSegmentation,
        SegformerImageProcessor,
    )

    device = torch.device(device)
    processor = SegformerImageProcessor.from_pretrained(model_name_or_path)
    model = SegformerForSemanticSegmentation.from_pretrained(
        model_name_or_path).eval().to(device)

    def segment(img: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            inputs = processor(images=img, return_tensors="pt")
            inputs = {k: v.to(device) for k, v in inputs.items()}
            logits = model(**inputs).logits
            pred = torch.nn.functional.interpolate(
                logits, size=img.shape[:2], mode="bilinear",
                align_corners=False).argmax(1)[0]
        return (pred.cpu().numpy() + 1).astype(np.uint8)

    return segment


def segment_images(
    image_files: Iterable[str],
    segmenter: Segmenter,
    out_path: str,
    down_rate: float = 8.0,
    keep_full: bool = False,
    save_two_level: bool = False,
    every: int = 1,
    job: int = 1,
    cur_job: int = 1,
) -> List[str]:
    """Run the segmenter over frames and save npy class maps
    (reference: extract_scene_seg.py main loop incl. --job/--curJob
    sharding and the videoname/frame two-level layout)."""
    import cv2

    os.makedirs(out_path, exist_ok=True)
    files = list(image_files)[::every]
    written = []
    for count, img_file in enumerate(files, 1):
        if (count % job) != (cur_job - 1) % job:
            continue
        name = os.path.splitext(os.path.basename(img_file))[0]
        target = out_path
        if save_two_level:
            target = os.path.join(out_path, name.split("_F_")[0])
            os.makedirs(target, exist_ok=True)
        img = cv2.cvtColor(cv2.imread(img_file), cv2.COLOR_BGR2RGB)
        seg = segmenter(img)
        seg = resize_seg_map(seg, down_rate, keep_full=keep_full)
        out_file = os.path.join(target, "%s.npy" % name)
        np.save(out_file, seg)
        written.append(out_file)
    return written
