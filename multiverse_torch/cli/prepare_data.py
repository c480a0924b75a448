"""The port's data-preparation commands: raw annotations → the TSVs,
pickles and split lists that ``mvt-torch-preprocess`` and the
multi-future evaluators read.

The port's copy of ``multiverse_tpu/cli/prepare_data.py``: each
``mvt-torch-*`` command takes the positional arguments and flags of the
``mvt-*`` command of the same name, prints what it prints and writes the
same files (host numpy, as there). One module, several console entry
points:

    mvt-torch-prepare-multifuture  reference: forking_paths_dataset/
                                   code/get_prepared_data_multifuture.py
    mvt-torch-prepare-anchor       reference: forking_paths_dataset/
                                   code/get_prepared_data.py
    mvt-torch-prepare-sdd          reference: SimAug/code/
                                   get_prepared_data_sdd.py
    mvt-torch-prepare-argoverse    reference: SimAug/code/
                                   get_prepared_data_argoverse.py
    mvt-torch-extract-scene-seg    reference: SimAug/code/
                                   extract_scene_seg.py
    mvt-torch-combine-traj         reference: forking_paths_dataset/
                                   code/combine_traj.py
    mvt-torch-gen-moments          reference: forking_paths_dataset/
                                   code/gen_moment_from_annotation.py
    mvt-torch-sdd-frames           reference: SimAug/code/get_frames_sdd.py
    mvt-torch-resize-rotate-sdd    reference: SimAug/code/
                                   resize_rotate_sdd.py
    mvt-torch-sdd-splits           reference: SimAug/code/get_sdd_splits.py
    mvt-torch-get-vehicle-traj     reference: forking_paths_dataset/
                                   code/get_vehicle_traj.py
    mvt-torch-split-path           reference: forking_paths_dataset/
                                   code/get_split_path.py

``mvt-torch-sdd-frames`` and ``mvt-torch-resize-rotate-sdd`` decode
video with ``cv2``, ``mvt-torch-get-vehicle-traj`` reads VIRAT YAML
with ``yaml``, ``mvt-torch-extract-scene-seg`` reads images with
``cv2`` and runs ``tensorflow`` (a ``.pb``) or ``transformers`` (a
SegFormer directory): where the package is missing they stop as they
start, with an ``ImportError`` that names it and the command.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os


def require_package(module: str, command: str) -> None:
    """Raise an ImportError naming ``module`` and ``command`` unless
    ``module`` imports: a command that needs an optional package fails
    before it writes anything."""
    try:
        importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            "%s needs the %r package, which cannot be imported here (%s)"
            % (command, module, e), name=module) from e


def _read_lst(path: str) -> list:
    return [os.path.splitext(os.path.basename(line.strip()))[0]
            for line in open(path) if line.strip()]


def prepare_multifuture_main(argv=None) -> None:
    from multiverse_torch.forking_paths.prepared_data import (
        prepare_multifuture_split,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-prepare-multifuture")
    parser.add_argument("dataset_path")
    parser.add_argument("split_path")
    parser.add_argument("outpath_obs")
    parser.add_argument("outpath_multifuture")
    parser.add_argument("--obs_length", type=int, default=8)
    args = parser.parse_args(argv)
    for split in ("train", "val", "test"):
        lst = os.path.join(args.split_path, "%s.lst" % split)
        if not os.path.exists(lst):
            continue
        names = _read_lst(lst)
        if not names:
            continue
        stats = prepare_multifuture_split(
            args.dataset_path, names, args.outpath_obs,
            args.outpath_multifuture, split,
            obs_length=args.obs_length)
        print("%s: %s" % (split, stats))


def prepare_anchor_main(argv=None) -> None:
    """Anchor (single-future) dataset -> trajectory TSVs + box pickles
    over all sampled frames (reference:
    forking_paths_dataset/code/get_prepared_data.py:12-15 — same
    positional dataset_path/split_path/outpath surface)."""
    from multiverse_torch.forking_paths.prepared_data import (
        prepare_anchor_split,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-prepare-anchor")
    parser.add_argument("dataset_path")
    parser.add_argument("split_path")
    parser.add_argument("outpath")
    parser.add_argument("--drop_frame", type=int, default=None,
                        help="frame subsampling (default: the virat "
                             "rate the reference hardcodes)")
    parser.add_argument("--min_frames", type=int, default=20)
    args = parser.parse_args(argv)
    kw = {"min_frames": args.min_frames}
    if args.drop_frame is not None:
        kw["drop_frame"] = args.drop_frame
    for split in ("train", "val", "test"):
        lst = os.path.join(args.split_path, "%s.lst" % split)
        if not os.path.exists(lst):
            continue
        names = _read_lst(lst)
        if not names:
            continue
        counts = prepare_anchor_split(
            args.dataset_path, names, args.outpath, split, **kw)
        print("%s: %d videos, frames min/max/avg %d/%d/%.1f" % (
            split, len(counts), min(counts), max(counts),
            sum(counts) / len(counts)) if counts
            else "%s: 0 videos" % split)


def prepare_sdd_main(argv=None) -> None:
    from multiverse_torch.data.sdd import parse_changelst, prepare_sdd_split

    parser = argparse.ArgumentParser(prog="mvt-torch-prepare-sdd")
    parser.add_argument("annotation_path")
    parser.add_argument("split_path")
    parser.add_argument("changelst")
    parser.add_argument("outpath")
    args = parser.parse_args(argv)
    changelst = parse_changelst(args.changelst)
    counts = []
    for split in ("train", "val", "test"):
        lst = os.path.join(args.split_path, "%s.lst" % split)
        if not os.path.exists(lst):
            continue
        counts += prepare_sdd_split(
            args.annotation_path, _read_lst(lst), changelst,
            args.outpath, split)
    if counts:
        import numpy as np

        print("total %d videos, frames min/max/avg %d/%d/%.1f" % (
            len(counts), min(counts), max(counts), np.mean(counts)))


def prepare_argoverse_main(argv=None) -> None:
    """Argoverse tracking logs -> trajectory TSVs + box pickles
    (reference: SimAug/code/get_prepared_data_argoverse.py __main__:
    one log directory per "video", ring_front_center camera)."""
    from glob import glob

    from multiverse_torch.data.argoverse import prepare_argoverse_log

    parser = argparse.ArgumentParser(prog="mvt-torch-prepare-argoverse")
    parser.add_argument("datapath",
                        help="dir of Argoverse log dirs, each with "
                             "per_sweep_annotations_amodal/*.json + "
                             "vehicle_calibration_info.json")
    parser.add_argument("outpath")
    parser.add_argument("--split", default="test")
    args = parser.parse_args(argv)
    total = 0
    for log_dir in sorted(glob(os.path.join(args.datapath, "*"))):
        if not os.path.isdir(log_dir):
            continue
        labels = sorted(glob(os.path.join(
            log_dir, "per_sweep_annotations_amodal", "*.json")))
        cal = os.path.join(log_dir, "vehicle_calibration_info.json")
        if not labels or not os.path.exists(cal):
            continue
        video_id = os.path.basename(log_dir.rstrip("/"))
        n = prepare_argoverse_log(
            labels, cal, video_id, args.outpath, split=args.split)
        if n == 0:
            print("warning: %s has too few pedestrian frames, "
                  "skipped" % video_id)
        total += n
    print("wrote %d trajectory rows" % total)


def extract_scene_seg_main(argv=None) -> None:
    """Frame jpgs -> downsampled scene class-map npys (reference:
    SimAug/code/extract_scene_seg.py). A ``.pb`` model is a DeepLab
    frozen graph run by tensorflow on the host; anything else is a
    SegFormer directory run by transformers on ``--device``."""
    from multiverse_torch.data.scene_extract import (
        make_segformer_segmenter,
        make_tf_deeplab_segmenter,
        segment_images,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-extract-scene-seg")
    parser.add_argument("imglst")
    parser.add_argument("model_path",
                        help="DeepLab frozen .pb or a SegFormer dir")
    parser.add_argument("out_path")
    parser.add_argument("--down_rate", type=float, default=8.0)
    parser.add_argument("--keep_full", action="store_true")
    parser.add_argument("--save_two_level", action="store_true")
    parser.add_argument("--every", type=int, default=1)
    parser.add_argument("--job", type=int, default=1)
    parser.add_argument("--curJob", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="where the SegFormer model runs")
    args = parser.parse_args(argv)
    require_package("cv2", parser.prog)
    if args.model_path.endswith(".pb"):
        require_package("tensorflow", parser.prog)
        segmenter = make_tf_deeplab_segmenter(args.model_path)
    else:
        require_package("transformers", parser.prog)
        segmenter = make_segformer_segmenter(args.model_path,
                                             device=args.device)
    files = [line.strip() for line in open(args.imglst) if line.strip()]
    written = segment_images(
        files, segmenter, args.out_path,
        down_rate=args.down_rate, keep_full=args.keep_full,
        save_two_level=args.save_two_level, every=args.every,
        job=args.job, cur_job=args.curJob)
    print("wrote %d seg maps" % len(written))


def combine_traj_main(argv=None) -> None:
    from multiverse_torch.forking_paths.moments import (
        combine_split_trajectories,
        load_homographies,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-combine-traj")
    parser.add_argument("split_path")
    parser.add_argument("target_path")
    parser.add_argument("frame_file")
    parser.add_argument("--reverse_xy", action="store_true")
    parser.add_argument("--is_actev", action="store_true")
    parser.add_argument("--h_path", default=None)
    parser.add_argument("--target_w_path", default=None)
    args = parser.parse_args(argv)

    hom = None
    if args.is_actev:
        hom = load_homographies(args.h_path)
    trajs, world, frames = combine_split_trajectories(
        args.split_path, reverse_xy=args.reverse_xy, homographies=hom)

    def save(target, data):
        os.makedirs(target, exist_ok=True)
        for videoname, rows in data.items():
            with open(os.path.join(
                    target, "%s.txt" % videoname), "w") as f:
                for fi, pid, x, y in rows:
                    f.write("%.1f\t%.1f\t%.3f\t%.3f\n" % (fi, pid, x, y))

    with open(args.frame_file, "w") as f:
        json.dump(frames, f)
    save(args.target_path, trajs)
    if args.is_actev and args.target_w_path:
        save(args.target_w_path, world)


def gen_moments_main(argv=None) -> None:
    from multiverse_torch.forking_paths.moments import (
        build_final_moments,
        save_moment_json,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-gen-moments")
    parser.add_argument("moment_filelst")
    parser.add_argument("annotation_jsonlst",
                        help="lines of `filepath annotator_id`")
    parser.add_argument("final_json")
    parser.add_argument("--video_fps", type=float, default=30.0)
    args = parser.parse_args(argv)

    moment_data = []
    for filename in open(args.moment_filelst):
        with open(filename.strip()) as f:
            moment_data += json.load(f)

    annotations = {}
    for line in open(args.annotation_jsonlst):
        annotation_file, annotator_id = line.strip().split()
        with open(annotation_file) as f:
            for traj_key, anno in json.load(f).items():
                key = (traj_key, annotator_id)
                if key in annotations:
                    raise ValueError("%s duplicated" % (key,))
                annotations[key] = anno

    moments = build_final_moments(
        moment_data, annotations, video_fps=args.video_fps)
    save_moment_json(moments, args.final_json)
    print("wrote %d moments -> %s" % (len(moments), args.final_json))


def sdd_frames_main(argv=None) -> None:
    """Extract the trajectory-referenced frames of each SDD video as
    jpgs (reference: SimAug/code/get_frames_sdd.py): read every
    traj txt under traj_anno_path/*/ to collect the frame ids each
    video needs, then decode only those, with the reference's
    detection-style --resize (min side --size, max side --maxsize),
    --use_2level / --name_level output layouts, per-video --statspath
    stats pickles, and --job/--curJob sharding."""
    import pickle
    from glob import glob

    from multiverse_torch.data.sdd import extract_needed_frames

    parser = argparse.ArgumentParser(prog="mvt-torch-sdd-frames")
    parser.add_argument("videolist", help="one video file per line")
    parser.add_argument("traj_anno_path",
                        help="<split>/<video>.txt trajectory files")
    parser.add_argument("despath")
    parser.add_argument("--size", default=800, type=int)
    parser.add_argument("--maxsize", default=1333, type=int)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--job", type=int, default=1)
    parser.add_argument("--curJob", type=int, default=1)
    parser.add_argument("--statspath", default=None,
                        help="write <video>.p stats pickles here")
    parser.add_argument("--use_2level", action="store_true",
                        help="write despath/<video>/ frame dirs")
    parser.add_argument("--name_level", type=int, default=None,
                        help="prefix the videoname with its last N "
                             "parent folder names, '__'-joined")
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-sdd-frames")

    video2frames: dict = {}
    for traj_file in glob(os.path.join(
            args.traj_anno_path, "*", "*.txt")):
        video_id = os.path.splitext(os.path.basename(traj_file))[0]
        frames = video2frames.setdefault(video_id, set())
        with open(traj_file) as f:
            for line in f:
                frames.add(int(float(line.split("\t")[0])))

    os.makedirs(args.despath, exist_ok=True)
    if args.statspath is not None:
        os.makedirs(args.statspath, exist_ok=True)

    total = 0
    for count, line in enumerate(open(args.videolist), start=1):
        if (count % args.job) != (args.curJob - 1) % args.job:
            continue
        video = line.strip()
        videoname = os.path.splitext(os.path.basename(video))[0]
        targetpath = args.despath
        if args.use_2level:
            targetpath = os.path.join(args.despath, videoname)
        if args.name_level is not None:
            parts = video.split("/")
            videoname = "__".join(
                parts[-1 - args.name_level:-1] + [videoname])
        if videoname not in video2frames:
            print("warning, %s not in traj files." % videoname)
            continue
        saved, stats = extract_needed_frames(
            video, sorted(video2frames[videoname]), targetpath,
            videoname, resize=args.resize, size=args.size,
            maxsize=args.maxsize)
        total += saved
        if args.statspath is not None:
            with open(os.path.join(
                    args.statspath, "%s.p" % videoname), "wb") as f:
                pickle.dump(stats, f)
    print("wrote %d frames" % total)


def resize_rotate_sdd_main(argv=None) -> None:
    """Normalize raw SDD videos to 1920x1080 landscape, rotating
    portrait ones 90° clockwise, and record the changes list the SDD
    prep consumes (reference: SimAug/code/resize_rotate_sdd.py —
    ffmpeg there, cv2 here since the image carries no ffmpeg)."""
    from multiverse_torch.data.sdd import resize_rotate_video

    parser = argparse.ArgumentParser(prog="mvt-torch-resize-rotate-sdd")
    parser.add_argument("videolst", help="one raw video path per line; "
                        "ids are <scene>_<video> from the last two "
                        "parent dirs")
    parser.add_argument("outpath")
    parser.add_argument("changelst",
                        help="written as video_id,WxH,rotated lines")
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-resize-rotate-sdd")

    os.makedirs(args.outpath, exist_ok=True)
    changes = []
    for line in open(args.videolst):
        videofile = line.strip()
        if not videofile:
            continue
        video_id = "%s_%s" % tuple(videofile.split("/")[-3:-1])
        target = os.path.join(args.outpath, "%s.mp4" % video_id)
        assert not os.path.exists(target), target
        resolution, rotated = resize_rotate_video(videofile, target)
        changes.append("%s,%s,%s" % (video_id, resolution, rotated))
    with open(args.changelst, "w") as f:
        f.write("\n".join(changes) + ("\n" if changes else ""))
    print("converted %d videos" % len(changes))


def sdd_splits_main(argv=None) -> None:
    """n-fold cross-validation split lists for SDD
    (reference: SimAug/code/get_sdd_splits.py)."""
    from multiverse_torch.data.sdd import write_sdd_fold_splits

    parser = argparse.ArgumentParser(prog="mvt-torch-sdd-splits")
    parser.add_argument("videolst")
    parser.add_argument("splitpath")
    parser.add_argument("--n_fold", default=5, type=int)
    parser.add_argument("--seed", default=2020, type=int,
                        help="shuffle seed (the reference shuffles "
                             "unseeded; seeded here for reproducible "
                             "folds)")
    args = parser.parse_args(argv)
    videos = [os.path.basename(line.strip())
              for line in open(args.videolst) if line.strip()]
    write_sdd_fold_splits(videos, args.splitpath,
                          n_fold=args.n_fold, seed=args.seed)
    print("wrote %d folds for %d videos" % (args.n_fold, len(videos)))


def get_vehicle_traj_main(argv=None) -> None:
    """VIRAT YAML vehicle annotations → per-video pixel/world
    trajectory TSVs at the pedestrian frames
    (reference: forking_paths_dataset/code/get_vehicle_traj.py)."""
    from glob import glob

    import numpy as np

    from multiverse_torch.forking_paths.controls import load_traj_file
    from multiverse_torch.forking_paths.moments import (
        ACTEV_SCENE2IMGSIZE,
        get_scene,
        load_homographies,
        load_virat_boxes,
        load_virat_types,
        vehicle_trajectories,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-get-vehicle-traj")
    parser.add_argument("traj_path", help="path to pedestrian dataset")
    parser.add_argument("anno_path", help="yaml path")
    parser.add_argument("h_path", help="path to homography matrix")
    parser.add_argument("out_path")
    parser.add_argument("--job", type=int, default=1, help="total job")
    parser.add_argument("--curJob", type=int, default=1,
                        help="this script run job Num")
    args = parser.parse_args(argv)
    require_package("yaml", "mvt-torch-get-vehicle-traj")

    out_pixel = os.path.join(args.out_path, "pixel")
    out_world = os.path.join(args.out_path, "world")
    os.makedirs(out_pixel, exist_ok=True)
    os.makedirs(out_world, exist_ok=True)
    h_dict = load_homographies(args.h_path)

    def save(rows, path, videoname):
        with open(os.path.join(path, "%s.txt" % videoname), "w") as f:
            for one in rows:
                f.write("%s\n" % "\t".join("%s" % x for x in one))

    count = 0
    for traj_file in sorted(glob(os.path.join(args.traj_path,
                                              "*.txt"))):
        count += 1
        if (count % args.job) != (args.curJob - 1):
            continue
        videoname = os.path.splitext(os.path.basename(traj_file))[0]
        scene = get_scene(videoname)
        # pedestrian frames define which vehicle boxes matter
        frame_ids = np.unique(
            load_traj_file(traj_file)[:, 0]).astype(int).tolist()
        vehicle_ids = load_virat_types(
            os.path.join(args.anno_path, videoname + ".types.yml"),
            only="Vehicle")
        boxes = load_virat_boxes(
            os.path.join(args.anno_path, videoname + ".geom.yml"),
            ACTEV_SCENE2IMGSIZE[scene])
        pixel, world = vehicle_trajectories(
            boxes, vehicle_ids, h_dict[scene], scene,
            frame_ids=frame_ids)
        save(pixel, out_pixel, videoname)
        save(world, out_world, videoname)


def split_path_main(argv=None) -> None:
    """Split lists for the rendered datasets: multi-future videos are
    all test; anchor videos follow their VIRAT source's original split
    (reference: forking_paths_dataset/code/get_split_path.py)."""
    from glob import glob

    from multiverse_torch.forking_paths.prepared_data import (
        reference_split_lists,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-split-path")
    parser.add_argument("video_path")
    parser.add_argument("split_path")
    parser.add_argument("--is_anchor", action="store_true")
    parser.add_argument("--ori_split_path", default=None)
    args = parser.parse_args(argv)

    videonames = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob(os.path.join(args.video_path, "*.mp4")))
    reference_split_lists(
        videonames, args.split_path, is_anchor=args.is_anchor,
        ori_split_path=args.ori_split_path)
