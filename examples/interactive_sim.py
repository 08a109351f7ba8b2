"""Interactive simulation — drive the robot with the mouse while SLAM tracks.

The equivalent of the reference's WPF Simulation window
(Simulation/MainWindow.xaml.cs): left-drag teleports the lidar, right-drag
aims its heading, the wheel zooms, and the Reset button restarts both
pipelines — all while the jitted Hector + CoreSLAM steps run at the lidar
scan rate in a background thread.

    python examples/interactive_sim.py [--port 8801] [--platform gpu] [--no-coreslam]

then open http://localhost:8801 in a browser.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8801)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--no-coreslam", action="store_true",
                    help="run HectorSLAM only")
    ap.add_argument("--world", choices=["default", "office"],
                    default="default",
                    help="'office' loads the multi-room loop-closure "
                         "benchmark world (sim/field.office_field)")
    args = ap.parse_args()

    from slamnet_tpu.io.interactive import InteractiveSession, serve

    session = InteractiveSession(platform=args.platform,
                                 run_coreslam=not args.no_coreslam,
                                 world=args.world)
    srv = serve(session, port=args.port)
    print(f"interactive sim at http://localhost:{args.port} "
          f"(left-drag: move, right-drag: aim, wheel: zoom)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        session.stop()
        srv.shutdown()


if __name__ == "__main__":
    main()
