"""Command-line interface.

The reference has no CLI: scene, resolution, spp and asset paths are
hardcoded and chosen by (un)commenting lines (main.rs:50-55,
scenes.rs:398; a CLI is an unchecked TODO, TODO.md:136-140).  This is the
green-field config subsystem SURVEY.md §5.6 calls for.

Examples:
    python -m rt_tpu.cli --scene cover --size 400x225 --spp 10 --out out.png
    python -m rt_tpu.cli --scene cover --progressive --serve 8000
    python -m rt_tpu.cli --scene obj:model.obj --camera widecam --out m.png
    python -m rt_tpu.cli --scene gltf:scene.gltf --spp 64 --out s.png
    python -m rt_tpu.cli --scene cover --probe 200,150
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_scene(spec: str, camera, seed: int, texture_dir: str | None):
    from rt_tpu import scenes
    from rt_tpu.scene import SceneBuilder

    if spec == "cover":
        return scenes.cover_scene(11, 11, camera, z=-0.2, seed=seed, texture_dir=texture_dir)
    if spec == "cover-large":
        return scenes.cover_scene(300, 300, camera, z=-0.2, seed=seed, texture_dir=texture_dir)
    if spec == "earth":
        return scenes.earth_scene(texture_dir)
    if spec == "checkered":
        return scenes.gen_checkered()
    if spec == "textured":
        return scenes.textured_spheres_scene(texture_dir)
    if spec == "triangles":
        return scenes.triangle_scene(texture_dir)
    if spec.startswith("obj:"):
        from rt_tpu.io.obj_loader import load_obj

        b = SceneBuilder()
        mat = b.lambertian_rgb(0.8, 0.8, 0.8)
        for model in load_obj(spec[4:]):
            b.add_triangles(model["vertices"], model["uvs"], mat)
        even = b.solid_color((0.1, 0.1, 0.1))
        odd = b.solid_color((0.95, 0.95, 0.95))
        ground = b.lambertian(b.checker(0.75, even, odd))
        scenes.add_ground_plane(b, 1000.0, 1000.0, -0.2, ground)
        return b.build()
    if spec.startswith("gltf:"):
        from rt_tpu.io.gltf_loader import add_gltf_to_scene

        b = SceneBuilder()
        add_gltf_to_scene(b, spec[5:])
        return b.build()
    raise SystemExit(f"unknown scene: {spec!r}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rt_tpu", description=__doc__)
    parser.add_argument("--scene", default="cover",
                        help="cover | cover-large | earth | checkered | textured | triangles | obj:PATH | gltf:PATH")
    parser.add_argument("--camera", default="cam1",
                        choices=["cam1", "cam2", "widecam", "topdown"])
    parser.add_argument("--size", default="800x600", help="WIDTHxHEIGHT")
    parser.add_argument("--spp", type=int, default=32)
    parser.add_argument("--max-depth", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="render.png", help=".png or .ppm")
    parser.add_argument("--texture-dir", default=None,
                        help="directory with earth/mars/moon/saul textures")
    parser.add_argument("--progressive", action="store_true",
                        help="run the reference's 237-pass sweep schedule")
    parser.add_argument("--passes", type=int, default=None,
                        help="limit progressive passes")
    parser.add_argument("--checkpoint", default=None,
                        help="progressive checkpoint .npz (resume if exists)")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="sweeps between checkpoint writes")
    parser.add_argument("--metrics", default=None, help="JSONL metrics path")
    parser.add_argument("--serve", type=int, default=None,
                        help="HTTP preview port (progressive mode)")
    parser.add_argument("--term-preview", action="store_true",
                        help="live in-terminal preview (ANSI half-blocks; "
                        "kitty graphics when TERM supports it)")
    parser.add_argument("--probe", default=None, metavar="X,Y",
                        help="print click-debug info for pixel X,Y and exit")
    parser.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from rt_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig
    from rt_tpu.io import write_png, write_ppm

    width, height = (int(v) for v in args.size.split("x"))
    camera = getattr(scenes, {"topdown": "topdown_cam"}.get(args.camera, args.camera))(
        width, height
    )
    cfg = RenderConfig(
        width=width,
        height=height,
        samples_per_pixel=args.spp,
        max_depth=args.max_depth,
        seed=args.seed,
    )
    scene = build_scene(args.scene, camera, args.seed, args.texture_dir)
    n_prims = scene.num_prims
    print(f"Rendering a scene with {n_prims} shapes", file=sys.stderr)

    if args.probe:
        from rt_tpu.debug import debug_pixel

        x, y = (float(v) for v in args.probe.split(","))
        info = debug_pixel(scene, camera, x, y, cfg)
        print(json.dumps(info if info else {"miss": "hit the skybox"}, indent=2))
        return 0

    if args.progressive:
        from rt_tpu.progressive import ProgressiveRenderer

        renderer = ProgressiveRenderer(
            scene,
            camera,
            cfg,
            checkpoint_path=args.checkpoint,
            metrics_path=args.metrics,
            progress=True,  # indicatif-style sweep bar (profiling.ProgressBar)
            checkpoint_every=args.checkpoint_every,
        )
        server = None
        if args.serve is not None:
            from rt_tpu.debug import debug_pixel
            from rt_tpu.viewer import PreviewServer

            server = PreviewServer(
                args.serve, probe=lambda x, y: debug_pixel(scene, camera, x, y, cfg)
            ).start()
            print(f"preview at http://localhost:{server.port}", file=sys.stderr)

        term = None
        if args.term_preview:
            from rt_tpu.term_preview import TerminalPreview

            term = TerminalPreview()

        def on_sweep(image, metrics):
            if server is not None:
                server.update(image, metrics)
            if term is not None:
                term.update(
                    image,
                    {
                        k: metrics[k]
                        for k in ("pass", "total_spp", "mray_per_s")
                        if k in metrics
                    },
                )

        image = renderer.run(max_passes=args.passes, on_sweep=on_sweep)
    else:
        from rt_tpu.render import render_image

        image, metrics = render_image(scene, camera, cfg)
        print(json.dumps(metrics), file=sys.stderr)

    image = np.asarray(image)
    if args.out.endswith(".ppm"):
        write_ppm(args.out, image)
    else:
        write_png(args.out, image)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
