"""Interactive simulation UI — the WPF MainWindow as a tiny HTTP app.

The reference's Simulation window lets the user drag the robot around the
field with the mouse while both SLAM pipelines track it live
(MainWindow.xaml.cs):

- left mouse drag   -> teleport the lidar to the cursor  (:448-453)
- right mouse drag  -> point the heading at the cursor   (:459-465)
- mouse wheel       -> zoom the field view               (:471-479)
- Reset button      -> reset processors + start pose     (:485-489, :143-151)
- background Scan() thread at lidar rate with a first-divergence
  debug dump                                             (:136-199)

Equivalent here: a stdlib ThreadingHTTPServer serving one HTML page.
The browser posts pose/heading/reset commands; a background thread runs the
jitted Hector (and optionally CoreSLAM) step at the lidar scan rate; the
page polls JSON state (map PNG + poses + rates) ~10x/s.  Zero dependencies:
PNG encoding is the hand-rolled stdlib encoder in io/live.py.

Run: python examples/interactive_sim.py  (then open http://localhost:8801)
"""
from __future__ import annotations

import base64
import html
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class InteractiveSession:
    """Owns simulator + SLAM state and steps them; thread-safe snapshots.

    The reference's Scan() loop (MainWindow.xaml.cs:136-199): snapshot the
    (mouse-driven) real pose, ray-trace a revolution, update CoreSLAM with
    segments and Hector with the cloud (bootstrap = first 10 loops), check
    for first divergence.
    """

    def __init__(self, platform: str = "cpu", run_coreslam: bool = True,
                 seed: int = 0, world: str = "default"):
        from ..runtime import select_platform
        select_platform(platform)
        import jax
        import jax.numpy as jnp

        from ..core import CoreSlamConfig, HectorConfig, SimConfig
        from ..core.scan import Scan
        from ..models import coreslam, hector
        from ..sim import default_field, lidar

        self._jax, self._jnp = jax, jnp
        self._hector, self._coreslam = hector, coreslam
        self._Scan = Scan
        self.sim = SimConfig()
        self.hcfg = HectorConfig()
        self.ccfg = CoreSlamConfig() if run_coreslam else None
        if world == "office":
            # the multi-room loop-closure benchmark world (sim/field.py)
            from ..sim.field import office_field
            self.field = office_field()
        else:
            self.field = default_field(self.sim.field_scale,
                                       self.sim.field_offset)
        self.angles = jnp.asarray(lidar.revolution_angles(self.sim.num_scan_points))
        self._lidar = lidar
        self._key = jax.random.PRNGKey(seed)
        self._lock = threading.Lock()
        self.real_pose = np.asarray(self.sim.start_pose, np.float32)
        self.loops = 0
        self.diverged_at: Optional[int] = None
        self.scan_rate_ema = 0.0
        self._do_reset = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._init_states()

        sim = self.sim

        @jax.jit
        def h_step(state, real_pose, key, bootstrap):
            radii, valid = lidar.scan_revolution(
                self.field, real_pose, self.angles, sim.max_scan_dist,
                sim.measure_error, key)
            pts = jnp.stack([radii * jnp.cos(self.angles),
                             radii * jnp.sin(self.angles)], -1)
            cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
            return hector.update(state, cloud, state.match_pose, self.hcfg,
                                 map_without_matching=bootstrap)

        self._h_step = h_step

        if self.ccfg is not None:
            ccfg = self.ccfg

            @jax.jit
            def c_step(state, real_pose, key):
                radii, valid = lidar.scan_revolution(
                    self.field, real_pose, self.angles, sim.max_scan_dist,
                    sim.measure_error, key)
                pts = jnp.stack([radii * jnp.cos(self.angles),
                                 radii * jnp.sin(self.angles)], -1)
                cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
                return coreslam.update_cloud(state, cloud, state.pose, ccfg)

            self._c_step = c_step

    def _init_states(self):
        import jax
        start = self._jnp.asarray(self.sim.start_pose, self._jnp.float32)
        self.hstate = self._hector.init(self.hcfg, start)
        self.cstate = (self._coreslam.init(self.ccfg, start,
                                           key=jax.random.PRNGKey(1))
                       if self.ccfg is not None else None)

    # ---- mouse commands (MainWindow.xaml.cs:448-465) ----

    def set_position(self, x: float, y: float) -> None:
        """Left drag: teleport the lidar, keep heading (UpdateLidarPosition)."""
        with self._lock:
            self.real_pose = np.asarray(
                [x, y, self.real_pose[2]], np.float32)

    def set_heading_toward(self, x: float, y: float) -> None:
        """Right drag: heading = atan2(cursor - lidar) (UpdateLidarViewDirection)."""
        with self._lock:
            ang = math.atan2(y - float(self.real_pose[1]),
                             x - float(self.real_pose[0]))
            self.real_pose = np.asarray(
                [self.real_pose[0], self.real_pose[1], ang], np.float32)

    def reset(self) -> None:
        """Reset button: flag consumed at the top of the scan loop (:143-151)."""
        self._do_reset = True

    # ---- the scan loop ----

    def step(self) -> None:
        """One Scan() iteration; safe to call directly (tests) or from run()."""
        import jax
        if self._do_reset:
            self._init_states()
            with self._lock:
                self.real_pose = np.asarray(self.sim.start_pose, np.float32)
            self.loops = 0
            self.diverged_at = None
            self._do_reset = False
        with self._lock:
            snap = self.real_pose.copy()
        self._key, sub = jax.random.split(self._key)
        t0 = time.time()
        self.hstate, hinfo = self._h_step(
            self.hstate, self._jnp.asarray(snap), sub,
            self._jnp.asarray(self.loops < 10))
        if self.cstate is not None:
            self._key, sub = jax.random.split(self._key)
            self.cstate, _ = self._c_step(self.cstate,
                                          self._jnp.asarray(snap), sub)
        jax.block_until_ready(self.hstate.match_pose)
        dt = time.time() - t0
        self.scan_rate_ema = (0.9 * self.scan_rate_ema + 0.1 / max(dt, 1e-6)
                              if self.scan_rate_ema else 1.0 / max(dt, 1e-6))
        self.loops += 1
        # first-divergence oracle (MainWindow.xaml.cs:182-196)
        if self.diverged_at is None:
            est = np.asarray(self.hstate.match_pose)
            lin = float(np.hypot(*(est[:2] - snap[:2])))
            ang = abs(math.degrees((est[2] - snap[2] + math.pi)
                                   % (2 * math.pi) - math.pi))
            if lin > 1.0 or ang > 10.0:
                self.diverged_at = self.loops

    def run(self, max_rate: Optional[float] = None) -> None:
        """Background scan thread (lidarThread, MainWindow.xaml.cs:103)."""
        rate = max_rate or self.sim.scans_per_second
        self._running = True

        def loop():
            while self._running:
                t0 = time.time()
                self.step()
                sleep = 1.0 / rate - (time.time() - t0)
                if sleep > 0:
                    time.sleep(sleep)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ---- state for the browser ----

    def frame(self, level: int = 0) -> dict:
        """JSON-ready snapshot: map PNG (b64) + poses + stats.

        `level` selects a Hector pyramid level; level == -1 renders the
        CoreSLAM hole map instead (the reference's SLAM-selector combo box,
        MainWindow.xaml:20-27 / Draw() hole-map branch :227-249)."""
        from . import export
        from .live import _png_b64
        level = int(level)
        if level < 0 and self.cstate is not None:
            size = self.ccfg.hole_map_size
            bmp = (export.hole_map_u16(np.asarray(self.cstate.hole_map), size)
                   >> 8).astype(np.uint8)   # Gray16 -> 8-bit for the PNG
            level, res = -1, self.ccfg.physical_map_size / size
        else:
            level = max(0, min(self.hcfg.num_levels - 1, level))
            size = self.hcfg.level_sizes[level]
            off = self.hcfg.level_offsets[level]
            maps = np.asarray(self.hstate.maps)
            bmp = export.occupancy_bitmap(maps[off:off + size * size], size)
            res = float(self.hcfg.level_resolutions[level])
        with self._lock:
            real = [float(v) for v in self.real_pose]
        out = {
            "png": _png_b64(np.flipud(np.asarray(bmp).reshape(size, size))),
            "level": level,
            "size": size,
            "res": res,
            "real": real,
            "hector": [float(v) for v in np.asarray(self.hstate.match_pose)],
            "scan": int(self.loops),
            "rate": round(self.scan_rate_ema, 1),
            "diverged_at": self.diverged_at,
            "levels": list(self.hcfg.level_sizes),
            "has_coreslam": self.cstate is not None,
        }
        if self.cstate is not None:
            out["coreslam"] = [float(v) for v in np.asarray(self.cstate.pose)]
        return out


class _Handler(BaseHTTPRequestHandler):
    session: InteractiveSession  # set by serve()

    def log_message(self, *a):  # silence per-request stderr spam
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/state"):
            level = 0
            if "level=" in self.path:
                try:
                    level = int(self.path.split("level=")[1].split("&")[0])
                except ValueError:
                    pass
            self._json(self.session.frame(level))
        else:
            body = _PAGE.replace("__TITLE__", html.escape(
                "slamnet_tpu interactive simulation")).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n) or b"{}")
        if self.path == "/pose":
            self.session.set_position(float(data["x"]), float(data["y"]))
        elif self.path == "/heading":
            self.session.set_heading_toward(float(data["x"]), float(data["y"]))
        elif self.path == "/reset":
            self.session.reset()
        self._json({"ok": True})


def serve(session: InteractiveSession, port: int = 8801) -> ThreadingHTTPServer:
    """Start the scan thread + HTTP server; returns the (running) server."""
    _Handler.session = session
    session.run()
    srv = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { font-family: sans-serif; background: #111; color: #ddd; margin: 1em; }
 #wrap { max-width: 860px; margin: auto; }
 canvas { border: 1px solid #444; image-rendering: pixelated; width: 800px;
          cursor: crosshair; }
 .bar { margin: .5em 0; display: flex; gap: 1em; align-items: center; }
 button { background: #333; color: #ddd; border: 1px solid #555; padding: .3em 1em; }
 .legend span { margin-right: 1.2em; }
</style></head><body><div id="wrap">
<h3>__TITLE__</h3>
<div class="bar">
  <button id="reset">reset</button>
  <label>level <select id="level"></select></label>
  <span id="info"></span>
</div>
<canvas id="cv" width="800" height="800"></canvas>
<div class="legend"><span style="color:#f55">&#9632; real (drag: left=move,
right=aim)</span><span style="color:#5f5">&#9632; hector</span>
<span style="color:#59f">&#9632; coreslam</span>
<span>wheel: zoom</span></div>
<script>
const cv = document.getElementById('cv');
const ctx = cv.getContext('2d');
const info = document.getElementById('info');
const levelSel = document.getElementById('level');
let state = null, zoom = 1, img = new Image();
function worldOf(e) {
  // canvas pixel -> world meters (origin lower-left), undoing CSS zoom
  const r = cv.getBoundingClientRect();
  const px = (e.clientX - r.left) / r.width * cv.width;
  const py = (e.clientY - r.top) / r.height * cv.height;
  const span = state.size * state.res;
  return {x: px / cv.width * span, y: (1 - py / cv.height) * span};
}
cv.oncontextmenu = e => e.preventDefault();
function post(path, body) {
  fetch(path, {method: 'POST', body: JSON.stringify(body || {})});
}
function drive(e) {
  if (!state) return;
  if (e.buttons & 1) post('/pose', worldOf(e));
  if (e.buttons & 2) post('/heading', worldOf(e));
}
cv.onmousedown = drive;
cv.onmousemove = drive;
cv.onwheel = e => {
  e.preventDefault();
  zoom = Math.max(1, Math.min(8, zoom + Math.sign(e.deltaY) * -0.5));
  cv.style.width = (800 * zoom) + 'px';
};
document.getElementById('reset').onclick = () => post('/reset');
function mark(pose, color) {
  const span = state.size * state.res;
  const x = pose[0] / span * cv.width;
  const y = cv.height - pose[1] / span * cv.height;
  ctx.strokeStyle = color; ctx.lineWidth = 2;
  ctx.beginPath(); ctx.arc(x, y, 6, 0, 2 * Math.PI); ctx.stroke();
  ctx.beginPath(); ctx.moveTo(x, y);
  ctx.lineTo(x + 14 * Math.cos(pose[2]), y - 14 * Math.sin(pose[2]));
  ctx.stroke();
}
function draw() {
  if (!state) return;
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0, cv.width, cv.height);
  mark(state.real, '#f55');
  mark(state.hector, '#5f5');
  if (state.coreslam) mark(state.coreslam, '#59f');
  const err = Math.hypot(state.hector[0] - state.real[0],
                         state.hector[1] - state.real[1]);
  info.textContent = `scan ${state.scan}  ${state.rate} scans/s  ` +
    `hector err ${err.toFixed(3)} m` +
    (state.diverged_at ? `  DIVERGED@${state.diverged_at}` : '');
}
async function poll() {
  try {
    const r = await fetch('/state?level=' + (levelSel.value || 0));
    state = await r.json();
    if (!levelSel.options.length) {
      state.levels.forEach((s, i) => {
        const o = document.createElement('option');
        o.value = i; o.textContent = `hector ${i} (${s}px)`;
        levelSel.appendChild(o);
      });
      if (state.has_coreslam) {
        const o = document.createElement('option');
        o.value = -1; o.textContent = 'coreslam hole map';
        levelSel.appendChild(o);
      }
    }
    img.onload = draw;
    img.src = 'data:image/png;base64,' + state.png;
  } catch (e) {}
  setTimeout(poll, 120);
}
poll();
</script></div></body></html>
"""
