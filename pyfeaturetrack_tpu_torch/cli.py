"""Command-line driver: track a PGM sequence end to end (PyTorch port of
``pyfeaturetrack_tpu/cli.py``).

The reference has no CLI (its examples are its interface); this is the
framework's convenience surface for the same flows, with the JAX
package's flags and one more, ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions of the kernels):

    python -m pyfeaturetrack_tpu_torch examples/data/img*.pgm --out /tmp/run
    python -m pyfeaturetrack_tpu_torch examples/data/img*.pgm --affine 2 \
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pft-track",
        description="Track features through an image sequence "
                    "(KLT on PyTorch; CUDA kernels on the card).")
    ap.add_argument("frames", nargs="+",
                    help="frames in order (PGM natively; any "
                         "PIL-readable format otherwise)")
    ap.add_argument("--features", type=int, default=150)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--no-replace", action="store_true",
                    help="do not replace lost features")
    ap.add_argument("--affine", type=int, default=-1,
                    choices=[-1, 0, 1, 2],
                    help="affineConsistencyCheck mode")
    ap.add_argument("--lighting-insensitive", action="store_true",
                    help="gain/bias-normalized residuals in LK")
    ap.add_argument("--fb-check", type=float, default=None,
                    metavar="PX",
                    help="forward-backward consistency gate: reject "
                         "tracks whose round trip misses the start by "
                         "more than PX pixels (default host loop only)")
    ap.add_argument("--subpixel", action="store_true",
                    help="refine newly selected corners to sub-pixel "
                         "accuracy (gradient-orthogonality iteration, "
                         "ops/refine.py; default host loop only)")
    ap.add_argument("--mindist", type=int, default=10)
    ap.add_argument("--window", type=int, default=7)
    ap.add_argument("--search-range", type=int, default=15)
    ap.add_argument("--chunks", type=int, default=1,
                    help=">1: chunk-parallel tracking with stitching")
    ap.add_argument("--batched", action="store_true",
                    help="with --chunks: advance all chunks in lockstep "
                         "(one captured graph per frame step on the card; "
                         "replacement runs on the device)")
    ap.add_argument("--device-loop", action="store_true",
                    help="run the device-resident sequence loop (zero "
                         "per-frame host sync)")
    ap.add_argument("--stream", action="store_true",
                    help="serving mode: read each PGM lazily and feed "
                         "it through the streaming tracker (uint8 "
                         "staging, h2d overlapped with compute)")
    ap.add_argument("--chain", type=int, default=1,
                    help="with --device-loop/--stream: frames per "
                         "dispatched program (amortizes per-dispatch "
                         "overhead)")
    ap.add_argument("--overlays", action="store_true",
                    help="write per-frame PPM overlays")
    ap.add_argument("--flow", action="store_true",
                    help="dense optical flow: per-pixel KLT for every "
                         "consecutive frame pair -> flow.npz with "
                         "u/v/status (+ flow{i}.ppm wheel images with "
                         "--overlays)")
    ap.add_argument("--vo", action="store_true",
                    help="monocular visual odometry: output keyframe "
                         "poses + landmark map (requires --fx)")
    ap.add_argument("--fx", type=float, default=None,
                    help="focal length in px (VO); --fy defaults to it")
    ap.add_argument("--fy", type=float, default=None)
    ap.add_argument("--cx", type=float, default=None,
                    help="principal point (VO); defaults to image center")
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--kf-every", type=int, default=3,
                    help="VO keyframe cadence (frames)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="with --vo: detect revisits of mapped regions "
                         "and correct drift (guided re-tracking + PnP "
                         "loop edge + pose graph)")
    ap.add_argument("--right", nargs="+", default=None,
                    help="with --vo: rectified RIGHT frames (one per "
                         "left frame) for metric stereo VO")
    ap.add_argument("--baseline", type=float, default=None,
                    help="with --right: stereo baseline in world units")
    ap.add_argument("--depth", action="store_true",
                    help="dense metric depth from rectified stereo "
                         "pairs: per-pixel 1-D KLT disparity with the "
                         "left-right occlusion gate -> depth.npz "
                         "(requires --right/--baseline/--fx; "
                         "+ disp{i}.ppm maps with --overlays)")
    ap.add_argument("--max-disparity", type=float, default=64.0,
                    help="with --depth: disparity search range in px")
    ap.add_argument("--bootstrap-model", default="essential",
                    choices=("essential", "auto"),
                    help="with --vo: two-view bootstrap model — 'auto' "
                         "adds H/E model selection (robust to planar "
                         "scenes; rejects pure rotation)")
    ap.add_argument("--traj-format", default=None,
                    choices=("tum", "kitti"),
                    help="with --vo: additionally write the keyframe "
                         "trajectory as trajectory.tum / trajectory."
                         "kitti (TUM RGB-D / KITTI odometry formats)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.batched and args.chunks <= 1:
        ap.error("--batched requires --chunks > 1 "
                 "(lockstep mode advances chunk streams together)")
    if args.vo and args.fx is None:
        ap.error("--vo requires --fx (focal length in pixels)")
    if args.flow and (args.chunks > 1 or args.device_loop or args.stream
                      or args.vo):
        ap.error("--flow is mutually exclusive with --chunks/"
                 "--device-loop/--stream/--vo")
    if args.flow and len(args.frames) < 2:
        ap.error("--flow needs at least two frames")
    if args.fb_check is not None and (
            args.flow or args.vo or args.depth or args.stream
            or args.device_loop or args.chunks > 1):
        ap.error("--fb-check applies to the default host loop only")
    if args.subpixel and (
            args.flow or args.vo or args.depth or args.stream
            or args.device_loop or args.chunks > 1):
        ap.error("--subpixel applies to the default host loop only")
    if (args.right is not None) != (args.baseline is not None):
        ap.error("--right and --baseline must be given together")
    if args.right is not None and not (args.vo or args.depth):
        ap.error("--right/--baseline require --vo (stereo VO) or "
                 "--depth (dense stereo depth)")
    if args.depth:
        if args.right is None:
            ap.error("--depth requires --right/--baseline "
                     "(rectified stereo pairs)")
        if args.fx is None:
            ap.error("--depth requires --fx (metric depth needs the "
                     "focal length)")
        if args.vo or args.flow or args.stream or args.device_loop \
                or args.chunks > 1:
            ap.error("--depth is mutually exclusive with --vo/--flow/"
                     "--stream/--device-loop/--chunks")
    if args.traj_format is not None and not args.vo:
        ap.error("--traj-format requires --vo")
    if args.right is not None and len(args.right) != len(args.frames):
        ap.error("--right needs exactly one frame per left frame")
    if args.vo and (args.chunks > 1 or args.device_loop or args.stream):
        ap.error("--vo is mutually exclusive with --chunks/"
                 "--device-loop/--stream")
    if args.device_loop and args.chunks > 1:
        ap.error("--device-loop and --chunks are mutually exclusive")
    if args.stream and (args.chunks > 1 or args.device_loop):
        ap.error("--stream is mutually exclusive with --chunks/"
                 "--device-loop")

    import numpy as np
    import torch

    from .config import create_config
    from .features import FeatureTable
    from .errors import KLTSetVerbosity
    from .models.sequence import track_sequence
    from .utils.io import read_image, write_feature_table
    from .utils.viz import write_feature_list_to_ppm

    if args.verbose:
        KLTSetVerbosity(1)
    os.makedirs(args.out, exist_ok=True)

    # serving mode streams frames one at a time (a live deployment's
    # decoder); the batch modes need them all resident anyway and use
    # the decode-ahead loader pool
    from .utils.loader import load_frames
    frames = None if args.stream else load_frames(args.frames)
    cfg = create_config(
        search_range=args.search_range,
        mindist=args.mindist,
        window_width=args.window,
        window_height=args.window,
        affineConsistencyCheck=args.affine,
        lighting_insensitive=args.lighting_insensitive,
        sequentialMode=True,
    )

    dev = args.device
    if args.flow:
        from .ops.flow import dense_flow_pyramids, flow_to_rgb
        from .ops.track import build_track_pyramids
        from .utils.io import ppm_write
        from .utils.staging import stage_f32
        fcfg = cfg.validated_window()  # odd-window clamp, like track
        us, vs, sts = [], [], []
        pyr_prev = build_track_pyramids(stage_f32(frames[0], dev), fcfg)
        for i in range(1, len(frames)):
            pyr_cur = build_track_pyramids(stage_f32(frames[i], dev), fcfg)
            fl = dense_flow_pyramids(pyr_prev, pyr_cur, fcfg)
            pyr_prev = pyr_cur
            u, v, st = (t.cpu().numpy() for t in (fl.u, fl.v, fl.status))
            us.append(u)
            vs.append(v)
            sts.append(st)
            if args.overlays:
                ppm_write(os.path.join(args.out, f"flow{i}.ppm"),
                          flow_to_rgb(u, v))
        np.savez(os.path.join(args.out, "flow.npz"),
                 u=np.stack(us), v=np.stack(vs), status=np.stack(sts))
        tracked = float(np.mean([(s == 0).mean() for s in sts]))
        summary = {"frames": len(frames), "flow": True,
                   "pairs": len(us),
                   "mean_tracked_fraction": round(tracked, 4)}
    elif args.depth:
        from .ops.disparity import dense_depth
        from .utils.io import ppm_write
        h, w = frames[0].shape
        fx = args.fx
        K = np.array([[fx, 0.0, w / 2.0], [0.0, fx, h / 2.0],
                      [0.0, 0.0, 1.0]])
        rights = [read_image(p) for p in args.right]
        depths, disps, valids = [], [], []
        for i, (fL, fR) in enumerate(zip(frames, rights)):
            depth, disp, valid = dense_depth(
                fL, fR, K, baseline=args.baseline, cfg=cfg,
                max_disparity=args.max_disparity, device=dev)
            depths.append(depth)
            disps.append(disp)
            valids.append(valid)
            if args.overlays:
                # disparity map, gated, scaled to 8-bit grey
                g = np.where(valid, disp, 0.0) / max(
                    args.max_disparity, 1e-9)
                g8 = (np.clip(g, 0, 1) * 255).astype(np.uint8)
                ppm_write(os.path.join(args.out, f"disp{i}.ppm"),
                          np.stack([g8, g8, g8], -1))
        np.savez(os.path.join(args.out, "depth.npz"),
                 depth=np.stack(depths), disparity=np.stack(disps),
                 valid=np.stack(valids), K=K,
                 baseline=float(args.baseline))
        mv = float(np.mean([v.mean() for v in valids]))
        md = float(np.median(np.concatenate(
            [d[v] for d, v in zip(depths, valids) if v.any()])))
        summary = {"frames": len(frames), "depth": True,
                   "pairs": len(depths),
                   "mean_valid_fraction": round(mv, 4),
                   "median_depth": round(md, 4)}
    elif args.vo:
        from .sfm.vo import VisualOdometry
        h, w = frames[0].shape
        fx = args.fx
        fy = args.fy if args.fy is not None else fx
        cx = args.cx if args.cx is not None else w / 2.0
        cy = args.cy if args.cy is not None else h / 2.0
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        vo = VisualOdometry(K, cfg=cfg, n_features=args.features,
                            kf_every=max(args.kf_every, 1),
                            loop_closure=args.loop_closure,
                            stereo_baseline=args.baseline,
                            bootstrap_model=args.bootstrap_model,
                            device=dev)
        if args.right is not None:
            rights = [read_image(p) for p in args.right]
            for f, r in zip(frames, rights):
                vo.feed(f, right=r)
        else:
            for f in frames:
                vo.feed(f)
        for e in vo.events:
            print(e, file=sys.stderr)
        if not vo.initialized:
            print(json.dumps({"frames": len(frames), "vo": True,
                              "initialized": False,
                              "hint": "needs more parallax/frames"}))
            return 1
        fi, R, t, c = vo.trajectory()
        np.savez(os.path.join(args.out, "trajectory.npz"),
                 keyframe_frames=fi, R=R, t=t, centers=c,
                 landmarks=vo.map_points(), K=K)
        if args.traj_format:
            from .utils.trajectory import write_kitti, write_tum
            tp = os.path.join(args.out, f"trajectory.{args.traj_format}")
            if args.traj_format == "tum":
                write_tum(tp, R, t, timestamps=fi.astype(np.float64))
            else:
                write_kitti(tp, R, t)
        summary = {"frames": len(frames), "vo": True,
                   "stereo": args.baseline is not None,
                   "keyframes": int(len(fi)),
                   "landmarks": int(len(vo.map_points())),
                   "loops_closed": len(vo.loops_closed),
                   "travel_units": round(
                       float(np.linalg.norm(c[-1] - c[0])), 4)}
    elif args.chunks > 1:
        from .models.chunked import track_sequence_chunked
        table, _, metrics_per_chunk = track_sequence_chunked(
            frames, cfg=cfg, n_features=args.features,
            n_chunks=args.chunks, replace_lost=not args.no_replace,
            batched=args.batched, chain=max(args.chain, 1), device=dev)
        np.savez(os.path.join(args.out, "tracks.npz"), **table)
        live_last = int((table["val"][-1] >= 0).sum())
        summary = {"frames": len(frames),
                   "global_tracks": int(table["val"].shape[1]),
                   "live_last_frame": live_last,
                   "chunks": args.chunks}
    elif args.stream or args.device_loop:
        from .features import feature_state_from_numpy
        if args.stream:
            from .serving import serve_stream
            from .utils.loader import FrameLoader
            tx, ty, tv = serve_stream(
                FrameLoader(args.frames), cfg=cfg,
                n_features=args.features,
                replace_lost=not args.no_replace,
                chain=max(args.chain, 1), stage_uint8=True, device=dev)
        else:
            from .models.device_sequence import track_sequence_device
            tx, ty, tv = track_sequence_device(
                frames, cfg=cfg, n_features=args.features,
                replace_lost=not args.no_replace, chain=max(args.chain, 1),
                device=dev)
        ft = FeatureTable(x=torch.as_tensor(tx), y=torch.as_tensor(ty),
                          val=torch.as_tensor(tv, dtype=torch.int32))
        if args.overlays:
            for i in range(len(tx)):
                fl = feature_state_from_numpy(
                    np.stack([tx[i], ty[i], tv[i]], -1), device="cpu")
                img = (read_image(args.frames[i]) if args.stream
                       else frames[i])
                write_feature_list_to_ppm(
                    fl, img, os.path.join(args.out, f"feat{i}.ppm"))
        write_feature_table(ft, os.path.join(args.out, "features.txt"),
                            fmt="%5.1f")
        write_feature_table(ft, os.path.join(args.out, "features.ft"))
        v = ft.val.numpy()
        summary = {"frames": len(tx),
                   "features": args.features,
                   "live_last_frame": int((v[-1] >= 0).sum()),
                   "full_tracks": int((v >= 0).all(axis=0).sum()),
                   "stream" if args.stream else "device_loop": True}
    else:
        def on_frame(i, fl):
            if args.overlays:
                write_feature_list_to_ppm(
                    fl, frames[i], os.path.join(args.out, f"feat{i}.ppm"))

        ft, metrics = track_sequence(
            frames, cfg=cfg, n_features=args.features,
            replace_lost=not args.no_replace, on_frame=on_frame,
            fb_max_displacement=args.fb_check,
            subpixel_refine=args.subpixel, device=dev)
        write_feature_table(ft, os.path.join(args.out, "features.txt"),
                            fmt="%5.1f")
        write_feature_table(ft, os.path.join(args.out, "features.ft"))
        v = ft.val.cpu().numpy()
        summary = {"frames": len(frames),
                   "features": args.features,
                   "live_last_frame": int((v[-1] >= 0).sum()),
                   "full_tracks": int((v >= 0).all(axis=0).sum())}

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
