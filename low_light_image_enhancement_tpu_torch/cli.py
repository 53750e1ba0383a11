"""Command-line interface of the port: ``llie-torch enhance [--raw] | eval |
serve | video | train`` (``bench`` is not ported yet and exits non-zero).

The port of the JAX package's ``cli.py`` (``llie``, which stays the JAX
package's), with the same config flags and ``--device cuda|cpu`` (default
``cuda``: every entry point runs on the card unless asked for the CPU).
``serve`` fronts the micro-batching EnhanceServer over HTTP
(http_server.py); ``enhance --raw`` takes an RGGB Bayer mosaic (``.npy``;
16-bit PNG or PGM where PIL imports) through the ISP and the pipeline
(``EnhancePipeline.enhance_raw``); ``video`` runs the temporally stable
frame-sequence path
(video.py), one stream or, with ``--streams``, one per directory; ``train``
trains the curve (zero-reference or paired, also hybrid), fcn or decom net
(train.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

from low_light_image_enhancement_tpu_torch.config import (
    PRESETS,
    PipelineConfig,
)

# what is not ported yet, and the ROADMAP.md item (Queue 1) that ports it
NOT_PORTED = {
    "bench": "the port's benchmark (ROADMAP.md Queue 1, item 1)",
}


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipeline runs (cpu: the kernels' plain "
                        "versions)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named benchmark config")
    p.add_argument("--method",
                   choices=["retinex", "curve", "hybrid", "fcn", "decom"],
                   default=None)
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--decom-gamma", type=float, default=None,
                   help="decom method's illumination exponent")
    p.add_argument("--denoise-strength", type=float, default=None)
    p.add_argument("--denoise-taps", choices=["sep", "full", "guided"],
                   default=None,
                   help="sep (default), full 3x3, or the guided-filter tail")
    p.add_argument("--denoise-guide", choices=["luma", "perchannel"],
                   default=None)
    p.add_argument("--guided-radius", type=int, default=None,
                   help="guided tail box radius (with --denoise-taps guided)")
    p.add_argument("--guided-eps", type=float, default=None,
                   help="guided tail edge/flat threshold")
    p.add_argument("--curve-downsample", type=int, choices=[1, 2, 4, 8],
                   default=None, help="estimate curve maps at 1/N res")
    p.add_argument("--conv-impl", choices=["auto", "xla", "pallas",
                                           "cascade", "gemm", "packed",
                                           "packed12"],
                   default=None,
                   help="the nets' convs: auto/xla F.conv2d, pallas the "
                        "port's conv kernels, cascade fcn's stack as one "
                        "kernel, gemm patch/im2col GEMMs, packed/packed12 "
                        "convs on space-to-depth lanes")
    p.add_argument("--data-shards", type=int, default=None,
                   help="shard batches over N devices (clamped to the "
                        "cards there are)")
    p.add_argument("--weights", default=None,
                   help="model weights: an .npz path or a shipped name "
                        "(models.weights.NAMED); default: the method's "
                        "shipped weights, or the preset's weights_name")


def _build_config(args) -> PipelineConfig:
    cfg = PRESETS[args.preset] if args.preset else PipelineConfig()
    over = {}
    for name in ("method", "gamma", "denoise_strength", "decom_gamma",
                 "denoise_taps", "denoise_guide", "guided_radius",
                 "guided_eps", "curve_downsample", "conv_impl",
                 "data_shards"):
        v = getattr(args, name, None)
        if v is not None:
            over[name] = v
    return cfg.replace(**over) if over else cfg


def _model_params(args):
    if args.weights is None:
        return None
    from low_light_image_enhancement_tpu_torch.models.weights import (
        params_from_numpy,
        resolve_weights,
    )

    return params_from_numpy(resolve_weights(args.weights))


def _pipeline(args, **kw):
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
    )

    return EnhancePipeline(_build_config(args),
                           model_params=_model_params(args),
                           device=args.device, **kw)


def _not_ported(what: str) -> int:
    print(f"llie-torch {what}: not in the port yet: {NOT_PORTED[what]}",
          file=sys.stderr)
    return 2


def _load_raw_mosaic(path: str):
    """Load a (H, W) Bayer mosaic: a .npy (u8, u16 or float, or int16/int32
    with values in [0, 65535], the common RAW container dtypes, converted
    to u16), or, where PIL imports, a single-channel image file (16-bit
    PNG or PGM load as u16 through PIL's modes I and I;16)."""
    import numpy as np

    from low_light_image_enhancement_tpu_torch.io import codec

    if path.endswith(".npy"):
        arr = np.load(path)
        if np.issubdtype(arr.dtype, np.signedinteger):
            # int16/int32 containers hold u16 sensor DNs: converted when
            # the values fit, refused otherwise (the float branch of
            # enhance_raw would clip DNs to [0, 1]: an all-white result)
            if arr.size and (arr.min() < 0 or arr.max() > 65535):
                raise ValueError(
                    f"--raw .npy {path} has {arr.dtype} values outside "
                    f"[0, 65535] ({arr.min()}..{arr.max()}); convert to "
                    "uint16 (with the sensor's white level) first")
            arr = arr.astype(np.uint16)
        return arr
    if codec.Image is None:
        raise ValueError(
            f"--raw {path}: reading a mosaic image file needs PIL, which "
            "is not installed here; save the mosaic as a .npy (u8, u16 or "
            "float) instead")
    img = codec.Image.open(path)
    if img.mode not in ("L", "I", "I;16"):
        raise ValueError(
            f"--raw expects a single-channel mosaic, got mode {img.mode!r} "
            f"from {path}; use a .npy, 16-bit PNG, or PGM file")
    arr = np.asarray(img)
    if arr.dtype == np.int32:   # PIL mode "I": 16-bit data, in range
        arr = arr.astype(np.uint16)
    return arr


def _wb_gains_arg(s: str):
    """argparse type of --wb-gains: 'R,G,B' floats -> (r, g, b), a parser
    error (not a traceback) on malformed input."""
    parts = s.split(",")
    try:
        vals = tuple(float(g) for g in parts)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--wb-gains wants three comma-separated numbers, got {s!r}")
    if len(vals) != 3:
        raise argparse.ArgumentTypeError(
            f"--wb-gains wants exactly three values (R,G,B), got "
            f"{len(vals)} in {s!r}")
    return vals


def cmd_enhance(args) -> int:
    pipe = _pipeline(args)
    if args.raw:
        from low_light_image_enhancement_tpu_torch.io.codec import (
            encode_image,
        )

        out = pipe.enhance_raw(_load_raw_mosaic(args.input),
                               wb_gains=args.wb_gains,
                               white_level=args.white_level)
        encode_image(out, args.output)
    else:
        pipe.enhance_file(args.input, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_eval(args) -> int:
    from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
    from low_light_image_enhancement_tpu_torch.eval.runner import eval_lol

    ds = LOLDataset(root=args.data_dir, split=args.split)
    report = eval_lol(_pipeline(args), ds, max_images=args.max_images,
                      parity=not args.no_parity)
    print(json.dumps(report, indent=2))
    return 0


def cmd_train(args) -> int:
    from low_light_image_enhancement_tpu_torch.train import (
        TrainConfig,
        train_curve_cnn,
        train_decom,
        train_fcn,
    )
    from low_light_image_enhancement_tpu_torch.utils.logging import (
        JSONLLogger,
        get_logger,
    )

    tcfg = TrainConfig(
        batch_size=args.batch, crop=args.crop, steps=args.steps,
        learning_rate=args.lr, ema_decay=args.ema_decay,
        denoise_in_loss=args.denoise_in_loss,
        eval_every=args.eval_every, eval_patience=args.eval_patience,
    )
    if args.model == "fcn":
        tcfg = dataclasses.replace(tcfg, features=24)
    logger = get_logger()
    jsonl = JSONLLogger(args.log_file) if args.log_file else None

    def log_fn(m):
        if "eval_score" in m:
            logger.info("step %s eval_score %.4f", m.get("step"),
                        m["eval_score"])
        else:
            logger.info("step %s loss %.4f", m.get("step"),
                        m.get("loss", 0.0))
        if jsonl:
            jsonl.log(m)

    kw = dict(checkpoint_dir=args.checkpoint_dir, resume=args.resume,
              log_fn=log_fn, device=args.device)
    queues = []  # the data factory's prefetch queues, closed at the end
    if args.data_dir is not None:
        # LOL pairs (or their synthetic stand-in) in place of the synthetic
        # stream; zeroref reads the lows alone. The prefetch queue's
        # workers decode ahead, so decoding overlaps the steps
        from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
        from low_light_image_enhancement_tpu_torch.io.prefetch import (
            PrefetchQueue,
        )

        ds = LOLDataset(root=args.data_dir, split="train")
        paired = not (args.model in ("curve", "hybrid")
                      and args.objective == "zeroref")

        def _data_factory(start_step):
            # resume-aware: a restore re-creates the stream at the
            # restored step, so a resumed run sees what a straight one does
            plans = ds.train_batch_plans(args.batch, args.crop,
                                         paired=paired,
                                         start_step=start_step)
            queues.append(PrefetchQueue(plans, depth=2,
                                        transform=ds.materialize_batch,
                                        workers=args.decode_workers,
                                        device=args.device))
            return queues[-1]

        kw["data_factory"] = _data_factory
    try:
        if args.model in ("curve", "hybrid"):
            params, _ = train_curve_cnn(tcfg, objective=args.objective,
                                        hybrid=args.model == "hybrid", **kw)
        elif args.model == "decom":
            params, _ = train_decom(tcfg, **kw)
        else:
            params, _ = train_fcn(tcfg, **kw)
    finally:
        for q in queues:
            q.close()
    if args.save_weights:
        from low_light_image_enhancement_tpu_torch.models.weights import (
            save_params,
        )

        save_params(params, args.save_weights)
        logger.info("weights saved to %s", args.save_weights)
    return 0


def cmd_serve(args) -> int:
    import signal

    from low_light_image_enhancement_tpu_torch.http_server import (
        HttpEnhanceServer,
    )
    from low_light_image_enhancement_tpu_torch.serving import EnhanceServer

    pipe = _pipeline(args, bucket=args.bucket)
    backend = EnhanceServer(pipe.config, pipeline=pipe,
                            max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            max_queue=args.max_queue, overflow=args.overflow)
    srv = HttpEnhanceServer(pipe.config, host=args.host, port=args.port,
                            enhance_server=backend)
    print(f"serving on http://{srv.host}:{srv.port} "
          "(POST /enhance, GET /healthz, GET /stats)", flush=True)

    # SIGTERM drains like Ctrl-C: stop accepting, finish the requests in
    # flight, exit 0
    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        backend.close()
    return 0


def cmd_video(args) -> int:
    import glob

    from low_light_image_enhancement_tpu_torch.io.codec import (
        decode_image,
        encode_image,
    )

    if args.streams:
        return _cmd_video_streams(args, decode_image, encode_image)

    from low_light_image_enhancement_tpu_torch.video import VideoEnhancer

    frames = sorted(glob.glob(args.input_glob))
    if not frames:
        print(f"no frames match {args.input_glob!r}", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    enh = VideoEnhancer(_build_config(args), alpha=args.alpha,
                        model_params=_model_params(args), device=args.device)
    for path in frames:
        out = enh.process(decode_image(path))
        encode_image(out, os.path.join(args.output_dir,
                                       os.path.basename(path)))
    print(f"wrote {len(frames)} frames to {args.output_dir} "
          f"(carry {enh.carry_bytes} bytes)")
    return 0


def _cmd_video_streams(args, decode_image, encode_image) -> int:
    """--streams: the glob matches one directory per independent stream;
    frame t of every stream goes through one batched step
    (MultiStreamVideoEnhancer). The streams advance together through their
    sorted frames and stop at the shortest stream."""
    import glob

    import numpy as np

    from low_light_image_enhancement_tpu_torch.io.prefetch import (
        PrefetchQueue,
    )
    from low_light_image_enhancement_tpu_torch.video import (
        MultiStreamVideoEnhancer,
    )

    dirs = sorted(d for d in glob.glob(args.input_glob) if os.path.isdir(d))
    if not dirs:
        print(f"no stream directories match {args.input_glob!r}",
              file=sys.stderr)
        return 1
    per_stream = []
    for d in dirs:
        fs = sorted(os.path.join(d, f) for f in os.listdir(d)
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not fs:
            print(f"stream directory {d!r} has no frames", file=sys.stderr)
            return 1
        per_stream.append(fs)
    n_frames = min(len(fs) for fs in per_stream)
    if any(len(fs) != n_frames for fs in per_stream):
        shortest = dirs[min(range(len(dirs)),
                            key=lambda i: len(per_stream[i]))]
        print(f"warning: streams have unequal frame counts "
              f"({n_frames}..{max(len(fs) for fs in per_stream)}); "
              f"truncating all to the shortest, {shortest!r}",
              file=sys.stderr)
    # an output directory per stream: the basename of the normalized path,
    # suffixed where two parents share one ('a/cam0', 'b/cam0')
    names, seen = [], {}
    for d in dirs:
        n = os.path.basename(os.path.normpath(d))
        if n in seen:
            seen[n] += 1
            n = f"{n}_{seen[n]}"
        else:
            seen[n] = 0
        names.append(n)
    enh = MultiStreamVideoEnhancer(len(dirs), _build_config(args),
                                   alpha=args.alpha,
                                   model_params=_model_params(args),
                                   device=args.device)
    for n in names:
        os.makedirs(os.path.join(args.output_dir, n), exist_ok=True)

    # batch t + 1 decodes on the prefetch thread while batch t is enhanced
    frame_paths = [tuple(fs[t] for fs in per_stream)
                   for t in range(n_frames)]

    def _decode_batch(paths):
        return np.stack([decode_image(p) for p in paths])

    try:
        for t, batch in enumerate(PrefetchQueue(
                frame_paths, transform=_decode_batch, device_put=False)):
            outs = enh.process(batch)
            for i, n in enumerate(names):
                encode_image(outs[i], os.path.join(
                    args.output_dir, n, os.path.basename(per_stream[i][t])))
    except ValueError as e:
        # frames of different sizes across the streams or within one
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {n_frames} frames x {len(dirs)} streams to "
          f"{args.output_dir} (carry {enh.carry_bytes} bytes)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    # the kernel library's objects are reused across processes from the
    # build directory (kernels/_build.py); LLIE_COMPILE_CACHE picks it, 0
    # turns reuse off
    from low_light_image_enhancement_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="llie-torch",
        description="low-light image enhancement on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("enhance", help="enhance one image file")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--raw", action="store_true",
                   help="input is an RGGB Bayer mosaic (.npy; 16-bit PNG or "
                        "PGM where PIL imports): the ISP (demosaic, white "
                        "balance, CCM) on the device, then the pipeline")
    p.add_argument("--wb-gains", default=None, metavar="R,G,B",
                   type=_wb_gains_arg,
                   help="white-balance gains for --raw (default: per-image "
                        "gray-world)")
    p.add_argument("--white-level", type=float, default=None,
                   help="full-scale mosaic value for --raw uint16 input "
                        "(e.g. 4095 for 12-bit sensors; default 65535)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_enhance)

    p = sub.add_parser("eval", help="run the LOL eval harness")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--split", default="eval15")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--no-parity", action="store_true")
    _add_config_args(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench", help=f"not ported yet: {NOT_PORTED['bench']}")
    p.set_defaults(fn=lambda args: _not_ported("bench"))

    p = sub.add_parser(
        "train", help="model training: curve/hybrid (zero-reference or "
                      "paired), fcn (supervised), decom (decomposition "
                      "objective)")
    p.add_argument("--model", choices=["curve", "hybrid", "fcn", "decom"],
                   default="curve")
    p.add_argument("--eval-every", type=int, default=0,
                   help="curve/hybrid: score held-out synthetic SSIM every "
                        "N steps, keep the best snapshot, stop after "
                        "--eval-patience evals that do not improve (0 = off)")
    p.add_argument("--eval-patience", type=int, default=3)
    p.add_argument("--denoise-in-loss", action="store_true",
                   help="the paired losses compare after the pipeline's "
                        "denoise tail (the shipped hybrid weights' recipe)")
    p.add_argument("--objective", choices=["zeroref", "paired"],
                   default="zeroref",
                   help="curve/hybrid objective; 'paired' is the shipped "
                        "weights' recipe")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data-dir", default=None,
                   help="train on LOL pairs from this root (our485 layout, "
                        "or the synthetic stand-in where it is absent; "
                        "random crop and flips, decoded on the prefetch "
                        "queue's workers) in place of the synthetic stream")
    p.add_argument("--decode-workers", type=int, default=1,
                   help="decode threads for --data-dir")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="track an EMA of the weights (e.g. 0.999) and "
                        "save/return the averaged weights")
    p.add_argument("--log-file", default=None)
    p.add_argument("--save-weights", default=None,
                   help="write the final params to this .npz (the JAX "
                        "package's layout)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the training runs")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "serve", help="HTTP enhancement server (POST /enhance with JPEG/PNG "
                      "bytes; a micro-batching dispatcher owns the device)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds a free port (printed at start-up)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=256,
                   help="bound on in-flight requests")
    p.add_argument("--overflow", choices=["block", "reject"],
                   default="reject",
                   help="a full server answers 503 (reject) or holds the "
                        "producer back (block)")
    p.add_argument("--bucket", type=int, default=64,
                   help="shape-bucket granularity")
    _add_config_args(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "video", help="enhance an ordered frame sequence with the "
                      "temporally stable video path")
    p.add_argument("input_glob",
                   help="glob over input frames, e.g. 'frames/*.png'; "
                        "processed in sorted order")
    p.add_argument("output_dir")
    p.add_argument("--alpha", type=float, default=0.3,
                   help="new-frame weight of the temporal EMA "
                        "(1.0 = no smoothing)")
    p.add_argument("--streams", action="store_true",
                   help="the glob matches directories, one stream each; "
                        "one frame of every stream is enhanced a batched "
                        "step (MultiStreamVideoEnhancer)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_video)

    args, rest = parser.parse_known_args(argv)
    if rest and args.command != "bench":
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
