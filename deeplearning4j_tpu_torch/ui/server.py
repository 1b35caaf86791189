"""Training UI server (port of ``ui/server.py``, host code over the
port's ``utils/http``; every endpoint answers as the JAX server's;
reference ``deeplearning4j-play/.../PlayUIServer.java:51`` +
``ui/module/train/TrainModule.java`` overview/model/system pages and
``ui/module/remote/RemoteReceiverModule.java`` for HTTP-posted stats).

Python stdlib ``http.server`` on a daemon thread — no Play/netty dependency;
the dashboard is a single self-contained HTML page (inline vanilla-JS canvas
charts, no CDN assets, for hosts without egress).

Endpoints:
  GET  /                      dashboard HTML (overview + per-layer model
                              drill-down + system sections, the
                              ``TrainModule.java`` page set)
  GET  /train/sessions        JSON list of session ids
  GET  /train/<sid>/overview  JSON score/time/param-norm series
  GET  /train/<sid>/model     JSON per-parameter stats of the latest record
  GET  /train/<sid>/param/<name>  JSON drill-down for one parameter:
                              mean-magnitude/std/norm series for the param
                              and its updates + the latest histograms
  GET  /train/<sid>/system    JSON memory series
  POST /remote                accept a posted StatsReport JSON (remote router)
  GET  /activations           latest conv activation grids page
                              (``ui/module/convolutional`` role)
  POST /activations           accept {"iteration": N, "svg": ...} from
                              ConvolutionalIterationListener(url=...)
  GET  /tsne                  embedding scatter page (``ui/module/tsne/TsneModule.java``)
  GET  /tsne/sessions         JSON list of uploaded coordinate sets
  GET  /tsne/coords/<sid>     JSON list of "x,y,label" lines
  POST /tsne/upload           upload coords CSV (body = text, one point/line)
  POST /tsne/post/<sid>       same, stored under an explicit session id
"""
from __future__ import annotations

import json
from typing import Optional
from urllib.parse import unquote
from urllib.request import Request, urlopen

from ..utils.http import BackgroundHttpServer, JsonHandler
from .stats import StatsReport
from .storage import InMemoryStatsStorage, StatsStorage

__all__ = ["UIServer", "RemoteUIStatsStorageRouter"]

# stored-injection guard for POST /activations: the grids page embeds the
# accepted payload verbatim, so this must be an allowlist over parsed XML,
# not a pattern scan of serialized text (scans miss SMIL attribute-targeting
# like <set attributeName="onmouseover">, <use>/<image> external references,
# and CSS url() exfil).  Element/attribute sets cover what our own listeners
# emit (ui/components.py, evaluation/tools.py) plus benign SVG structure.
_SVG_NS = "http://www.w3.org/2000/svg"
_SVG_ELEMENTS = frozenset({
    "svg", "g", "path", "rect", "circle", "ellipse", "line", "polyline",
    "polygon", "text", "tspan", "defs", "title", "desc", "linearGradient",
    "radialGradient", "stop", "clipPath", "mask", "marker", "symbol"})
_SVG_ATTRS = frozenset({
    "id", "class", "d", "x", "y", "x1", "y1", "x2", "y2", "cx", "cy", "r",
    "rx", "ry", "points", "width", "height", "viewBox", "transform",
    "fill", "stroke", "stroke-width", "stroke-dasharray", "stroke-linecap",
    "stroke-linejoin", "opacity", "fill-opacity", "stroke-opacity",
    "font-size", "font-family", "font-weight", "text-anchor",
    "dominant-baseline", "offset", "stop-color", "stop-opacity",
    "gradientUnits", "gradientTransform", "clip-path", "mask",
    "marker-start", "marker-mid", "marker-end", "dx", "dy",
    "preserveAspectRatio", "version",
    # style passes the same per-attribute url() constraint below, so it
    # can't carry external references; our _Chart frames use it
    "style"})


def _validate_activation_svg(svg) -> None:
    """Raise ValueError unless ``svg`` is a plain vector drawing.

    Layered: (1) reject DOCTYPE/PI/CDATA/comment markup outright — CDATA in
    particular parses as inert text in XML but the HTML embedding re-reads
    the raw bytes, where ``<![CDATA[<script>]]>`` IS a script tag; (2) scan
    entity-decoded variants for script vectors (a ``&lt;script&gt;`` text
    node is XML-safe but stays rejected — the stored string is the artifact,
    not the parse); (3) parse and allowlist element/attribute names, and
    constrain ``url()`` references to local fragments."""
    import html as _html
    import re as _re
    import xml.etree.ElementTree as _ET

    if not isinstance(svg, str):
        raise ValueError("svg payload must be a string")
    if not svg.lstrip()[:4].lower().startswith("<svg"):
        raise ValueError("svg payload must start with <svg")
    if "<!" in svg or "<?" in svg:
        raise ValueError("svg payload must not contain DOCTYPE/CDATA/"
                         "comment/processing-instruction markup")
    variants, cur = [svg], svg
    for _ in range(2):           # double-encoded payloads too
        nxt = _html.unescape(cur)
        if nxt == cur:           # fixpoint: no entities left
            break
        variants.append(nxt)
        cur = nxt
    for s in variants:
        low = s.lower()
        compact = _re.sub(r"[\x00-\x20]", "", low)
        if ("<script" in low or "<foreignobject" in low
                or "javascript:" in compact
                or _re.search(r"[\s/\"'>]on\w+\s*=", low)):
            raise ValueError("svg payload contains script vectors")
    try:
        root = _ET.fromstring(svg)
    except _ET.ParseError as e:
        raise ValueError(f"svg payload is not well-formed XML: {e}")
    for el in root.iter():
        if not isinstance(el.tag, str):      # Comment / PI nodes
            raise ValueError("svg payload must not contain comments or "
                             "processing instructions")
        ns, _, local = el.tag.rpartition("}")
        if ns and ns != "{" + _SVG_NS:
            raise ValueError(f"non-SVG namespace element {el.tag!r}")
        if local not in _SVG_ELEMENTS:
            raise ValueError(f"svg element <{local}> is not allowed")
        for name, value in el.attrib.items():
            if name.startswith("{") or name not in _SVG_ATTRS:
                raise ValueError(f"svg attribute {name!r} is not allowed")
            # CSS identifier escapes (\75rl( == url() would sidestep the
            # url() scan below; no legitimate drawing needs them
            if "\\" in value:
                raise ValueError(
                    f"svg attribute {name!r} contains escape sequences")
            # paint/clip references may only target local fragments
            # (quoted FuncIRI forms like url('#id') are local too)
            for m in _re.finditer(r"url\s*\(([^)]*)\)", value,
                                  _re.IGNORECASE):
                inner = m.group(1).strip().strip("'\"").strip()
                if not inner.startswith("#"):
                    raise ValueError(
                        f"svg attribute {name!r} references a non-local url")
            if _re.search(r"url\s*\([^)]*$", value, _re.IGNORECASE):
                raise ValueError(
                    f"svg attribute {name!r} has an unterminated url()")

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>dl4j-tpu training UI</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
h2{margin:8px 0} h3{margin:14px 0 4px} .chart{background:#fff;border:1px solid #ddd;margin:6px 0}
#sessions{margin-bottom:12px} select{margin:4px 8px 4px 0}
.row{display:flex;gap:14px;flex-wrap:wrap} a{color:#1565c0}</style></head><body>
<h2>dl4j-tpu training</h2>
<div>session: <select id="sid"></select>
 <label><input type="checkbox" id="compare"> compare all sessions</label></div>
<div><a href="/activations">conv activation grids</a> · <a href="/tsne">embedding scatter</a></div>
<h3>Score vs iteration</h3><canvas id="score" class="chart" width="900" height="240"></canvas>
<h3>Parameter L2 norms</h3><canvas id="norms" class="chart" width="900" height="240"></canvas>
<h3>Iteration time (ms)</h3><canvas id="times" class="chart" width="900" height="160"></canvas>
<h3>Model: per-parameter drill-down</h3>
<div>parameter: <select id="pname"></select></div>
<div class="row">
 <div><div>param histogram (latest)</div><canvas id="phist" class="chart" width="440" height="200"></canvas></div>
 <div><div>update histogram (latest)</div><canvas id="uhist" class="chart" width="440" height="200"></canvas></div>
</div>
<div>mean magnitude: parameter (blue) vs update (red)</div>
<canvas id="mags" class="chart" width="900" height="200"></canvas>
<div>parameter std (blue), mean (red)</div>
<canvas id="pstd" class="chart" width="900" height="160"></canvas>
<h3>System</h3>
<canvas id="mem" class="chart" width="900" height="200"></canvas>
<div id="memlabel"></div>
<script>
let sid=null;
function line(c,series,labels){const x=c.getContext('2d');x.clearRect(0,0,c.width,c.height);
 const all=series.flat().filter(v=>v!=null&&isFinite(v)); if(!all.length)return;
 const mi=Math.min(...all),ma=Math.max(...all),r=(ma-mi)||1;
 const colors=['#1565c0','#c62828','#2e7d32','#f9a825','#6a1b9a','#00838f'];
 series.forEach((s,si)=>{x.beginPath();x.strokeStyle=colors[si%colors.length];
  let started=false;
  s.forEach((v,i)=>{if(v==null||!isFinite(v)){started=false;return;}
   const px=30+i*(c.width-40)/Math.max(s.length-1,1),
   py=c.height-20-(v-mi)/r*(c.height-40);
   started?x.lineTo(px,py):x.moveTo(px,py);started=true;});
  x.stroke();
  if(labels&&labels[si]){x.fillStyle=colors[si%colors.length];
   x.fillText(labels[si],40+110*si,12);}});
 x.fillStyle='#333';x.fillText(ma.toPrecision(4),2,14);
 x.fillText(mi.toPrecision(4),2,c.height-22);}
function bars(c,hist,lo,hi){const x=c.getContext('2d');x.clearRect(0,0,c.width,c.height);
 if(!hist||!hist.length)return; const ma=Math.max(...hist)||1;
 const w=(c.width-40)/hist.length;
 hist.forEach((v,i)=>{const h=v/ma*(c.height-40);
  x.fillStyle='#1565c0';x.fillRect(30+i*w,c.height-20-h,w-1,h);});
 x.fillStyle='#333';
 if(lo!=null)x.fillText(lo.toPrecision(3),25,c.height-6);
 if(hi!=null)x.fillText(hi.toPrecision(3),c.width-60,c.height-6);}
async function refreshParam(){
 if(!sid)return; const sel=document.getElementById('pname');
 if(!sel.value)return;
 const d=await (await fetch('/train/'+sid+'/param/'+encodeURIComponent(sel.value))).json();
 bars(document.getElementById('phist'),d.param_hist,d.param_min,d.param_max);
 bars(document.getElementById('uhist'),d.update_hist,d.update_min,d.update_max);
 line(document.getElementById('mags'),[d.param_mean_magnitude,d.update_mean_magnitude],
      ['param','update']);
 line(document.getElementById('pstd'),[d.param_std,d.param_mean],['std','mean']);}
function syncSelect(sel,values,fallback){
 const have=[...sel.options].map(o=>o.value).join('\\u0000');
 if(have!==values.join('\\u0000')){const cur=sel.value;sel.innerHTML='';
  values.forEach(v=>{const op=document.createElement('option');
   op.value=op.text=v;sel.add(op);});
  sel.value=(cur&&values.includes(cur))?cur:fallback(values);}}
async function refresh(){
 const ss=await (await fetch('/train/sessions')).json();
 const ssel=document.getElementById('sid');
 syncSelect(ssel,ss,v=>v[v.length-1]);
 if(!ss.length)return; sid=ssel.value;
 let o;
 if(document.getElementById('compare').checked&&ss.length>1){
  // multi-session compare: overlay every session's score curve
  const all=await Promise.all(ss.map(s=>
    fetch('/train/'+s+'/overview').then(r=>r.json())));
  o=all[ss.indexOf(sid)];
  line(document.getElementById('score'),all.map(a=>a.scores),ss);
 }else{
  o=await (await fetch('/train/'+sid+'/overview')).json();
  line(document.getElementById('score'),[o.scores]);
 }
 const names=Object.keys(o.param_norms);
 line(document.getElementById('norms'),names.slice(0,6).map(n=>o.param_norms[n]),
      names.slice(0,6));
 line(document.getElementById('times'),[o.iter_times_ms]);
 syncSelect(document.getElementById('pname'),names,v=>v[0]);
 await refreshParam();
 const sys=await (await fetch('/train/'+sid+'/system')).json();
 const keys=[...new Set(sys.memory.flatMap(m=>Object.keys(m)))].slice(0,4);
 // units differ per key (kb vs bytes): normalize each series to its own
 // max so every line is readable; the label shows the latest raw values
 const raw=keys.map(k=>sys.memory.map(m=>m[k]??null));
 const normed=raw.map(s=>{const mx=Math.max(...s.filter(v=>v!=null))||1;
  return s.map(v=>v==null?null:v/mx);});
 line(document.getElementById('mem'),normed,keys);
 document.getElementById('memlabel').textContent='latest: '+keys.map((k,i)=>{
  const last=[...raw[i]].reverse().find(v=>v!=null);
  return k+'='+(last==null?'-':last.toExponential(2));}).join('  ');}
document.getElementById('pname').addEventListener('change',refreshParam);
document.getElementById('sid').addEventListener('change',refresh);
document.getElementById('compare').addEventListener('change',refresh);
refresh();setInterval(refresh,2000);
</script></body></html>"""

_ACT_PAGE_HEAD = """<!doctype html><html><head><meta charset="utf-8">
<title>dl4j-tpu conv activations</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
.grid{background:#fff;border:1px solid #ddd;margin:10px 0;padding:8px}
</style></head><body><h2>Conv activation grids</h2>
<div><a href="/">back to training</a></div>"""

_TSNE_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>dl4j-tpu embedding viewer</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
#plot{background:#fff;border:1px solid #ddd}</style></head><body>
<h2>Embedding scatter (t-SNE)</h2>
<div>session: <select id="sess"></select></div>
<canvas id="plot" width="900" height="700"></canvas>
<script>
async function sessions(){const ss=await (await fetch('/tsne/sessions')).json();
 const sel=document.getElementById('sess');sel.innerHTML='';
 ss.forEach(s=>{const o=document.createElement('option');o.value=o.text=s;sel.add(o);});
 if(ss.length)draw(sel.value);}
async function draw(sid){const lines=await (await fetch('/tsne/coords/'+sid)).json();
 const pts=lines.map(l=>l.split(',')).filter(p=>p.length>=2)
   .map(p=>({x:+p[0],y:+p[1],l:p[2]||''}));
 if(!pts.length)return;const c=document.getElementById('plot'),x=c.getContext('2d');
 x.clearRect(0,0,c.width,c.height);
 const xs=pts.map(p=>p.x),ys=pts.map(p=>p.y);
 const mx=Math.min(...xs),Mx=Math.max(...xs),my=Math.min(...ys),My=Math.max(...ys);
 pts.forEach(p=>{const px=20+(p.x-mx)/((Mx-mx)||1)*(c.width-40),
  py=20+(p.y-my)/((My-my)||1)*(c.height-40);
  x.fillStyle='#1565c0';x.beginPath();x.arc(px,py,2,0,6.3);x.fill();
  if(p.l){x.fillStyle='#333';x.fillText(p.l,px+3,py-3);}});}
document.getElementById('sess').addEventListener('change',e=>draw(e.target.value));
sessions();
</script></body></html>"""

_UPLOADED_FILE = "UploadedFile"


class _Handler(JsonHandler):
    storage: StatsStorage = None   # set by UIServer
    tsne_sessions: dict = None     # sid -> list[str] coordinate lines
    activations: list = None       # [{"iteration": N, "svg": ...}]

    def _training_report(self, sid: str, recs) -> str:
        """Server-rendered static training report BUILT FROM the component
        DSL (the reference's ui-components consumed by its server pages):
        the same ChartLine/ComponentTable/DecoratorAccordion objects users
        compose standalone reports with."""
        from .components import (ChartHistogram, ChartLine, ComponentTable,
                                 ComponentText, DecoratorAccordion,
                                 render_page)
        comps = [ComponentText(f"Training report — session {sid}",
                               size=18, bold=True)]
        if not recs:
            comps.append(ComponentText("no records for this session"))
            return render_page(comps, title=f"report {sid}")
        iters = [r.iteration for r in recs]
        score = (ChartLine(title="score vs iteration", x_label="iteration",
                           y_label="score")
                 .add_series("score", iters, [r.score or 0.0 for r in recs]))
        comps.append(score)
        norms = ChartLine(title="parameter L2 norms", x_label="iteration")
        # collect (iteration, norm) pairs while scanning: a parameter that
        # appears in only SOME records must pair with those records'
        # iterations, not with a same-length tail of the iteration axis
        series = {}
        for r in recs:
            for name, st in r.param_stats.items():
                series.setdefault(name, []).append(
                    (r.iteration, st.get("norm2") or 0.0))
        for name, pts in sorted(series.items()):
            norms.add_series(name, [it for it, _ in pts],
                            [v for _, v in pts])
        comps.append(DecoratorAccordion(title="Parameters",
                                        children=[norms]))
        last = recs[-1]
        hists = []
        for pname, st in sorted(last.param_stats.items()):
            h = st.get("hist")
            if not h:
                continue
            ch = ChartHistogram(title=pname)
            lo, hi = st.get("min", 0.0), st.get("max", 1.0)
            n = len(h)
            for i, c in enumerate(h):
                ch.add_bin(lo + (hi - lo) * i / n,
                           lo + (hi - lo) * (i + 1) / n, float(c))
            hists.append(ch)
        if hists:
            comps.append(DecoratorAccordion(
                title="Latest parameter histograms", children=hists,
                default_collapsed=True))
        comps.append(ComponentTable(
            header=["", "value"],
            rows=[["records", len(recs)],
                  ["last iteration", last.iteration],
                  ["last score", f"{(last.score or 0.0):.6g}"],
                  ["last iter time (ms)",
                   f"{(last.iter_time_ms or 0.0):.3g}"]],
            title="summary"))
        return render_page(comps, title=f"report {sid}")

    def _html(self, page: str):
        data = page.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if not parts:
            return self._html(_PAGE)
        if parts[0] == "tsne":
            if len(parts) == 1:
                return self._html(_TSNE_PAGE)
            if parts[1] == "sessions":
                return self._json(sorted(self.tsne_sessions))
            if parts[1] == "coords" and len(parts) == 3:
                return self._json(self.tsne_sessions.get(unquote(parts[2]), []))
            return self._json({"error": "not found"}, 404)
        if parts[0] == "activations":
            chunks = [f"<div class='grid'><h3>iteration {a['iteration']}"
                      f"</h3>{a['svg']}</div>"
                      for a in (self.activations or [])[-12:][::-1]]
            return self._html(_ACT_PAGE_HEAD + "".join(chunks)
                              + "</body></html>")
        if parts[0] != "train":
            return self._json({"error": "not found"}, 404)
        if len(parts) == 2 and parts[1] == "sessions":
            return self._json(self.storage.list_session_ids())
        if len(parts) >= 4 and parts[2] == "param":
            sid = parts[1]
            pname = unquote("/".join(parts[3:]))
            recs = self.storage.get_records(sid)

            def series(stats_attr, key):
                out = []
                for r in recs:
                    st = getattr(r, stats_attr).get(pname)
                    out.append(None if st is None else st.get(key))
                return out

            last_p = next((getattr(r, "param_stats").get(pname)
                           for r in reversed(recs)
                           if r.param_stats.get(pname)), {})
            last_u = next((getattr(r, "update_stats").get(pname)
                           for r in reversed(recs)
                           if r.update_stats.get(pname)), {})
            return self._json({
                "iterations": [r.iteration for r in recs],
                "param_mean_magnitude": series("param_stats",
                                               "mean_magnitude"),
                "param_std": series("param_stats", "std"),
                "param_mean": series("param_stats", "mean"),
                "param_norm2": series("param_stats", "norm2"),
                "update_mean_magnitude": series("update_stats",
                                                "mean_magnitude"),
                "param_hist": last_p.get("hist"),
                "param_min": last_p.get("min"),
                "param_max": last_p.get("max"),
                "update_hist": last_u.get("hist"),
                "update_min": last_u.get("min"),
                "update_max": last_u.get("max"),
            })
        if len(parts) == 3:
            sid, what = parts[1], parts[2]
            recs = self.storage.get_records(sid)
            if what == "report":
                return self._html(self._training_report(sid, recs))
            if what == "overview":
                norms = {}
                for r in recs:
                    for name, st in r.param_stats.items():
                        norms.setdefault(name, []).append(st.get("norm2"))
                return self._json({
                    "iterations": [r.iteration for r in recs],
                    "scores": [r.score for r in recs],
                    "iter_times_ms": [r.iter_time_ms for r in recs],
                    "param_norms": norms})
            if what == "model":
                last = recs[-1] if recs else None
                return self._json(last.to_dict() if last else {})
            if what == "system":
                return self._json({
                    "iterations": [r.iteration for r in recs],
                    "memory": [r.memory for r in recs]})
        return self._json({"error": "not found"}, 404)

    def do_POST(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if parts and parts[0] == "activations":
            try:
                payload = self._read_json()
                svg = payload["svg"]
                iteration = int(payload.get("iteration", 0))
                _validate_activation_svg(svg)
            except Exception as e:
                return self._json({"error": f"bad payload: {e}"}, 400)
            self.activations.append({"iteration": iteration, "svg": svg})
            del self.activations[:-50]   # bounded history
            return self._json({"ok": True})
        if parts and parts[0] == "tsne":
            text = self._read_body().decode("utf-8", errors="replace")
            lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
            if len(parts) == 2 and parts[1] == "upload":
                self.tsne_sessions[_UPLOADED_FILE] = lines
            elif len(parts) == 3 and parts[1] == "post":
                self.tsne_sessions[unquote(parts[2])] = lines
            else:
                return self._json({"error": "not found"}, 404)
            return self._json({"ok": True, "points": len(lines)})
        if self.path.rstrip("/") != "/remote":
            return self._json({"error": "not found"}, 404)
        try:
            report = StatsReport.from_dict(self._read_json())
        except Exception as e:  # malformed post must not kill the server
            return self._json({"error": str(e)}, 400)
        self.storage.put_record(report)
        return self._json({"ok": True})


class UIServer:
    """Attachable dashboard server (reference ``UIServer.getInstance()`` /
    ``PlayUIServer``).  ``attach(storage)`` routes that storage's sessions."""

    def __init__(self, port: int = 0):
        self._server = BackgroundHttpServer(_Handler, port,
                                            storage=InMemoryStatsStorage(),
                                            tsne_sessions={},
                                            activations=[])
        self._handler = self._server.httpd.RequestHandlerClass

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def storage(self) -> StatsStorage:
        return self._handler.storage

    def attach(self, storage: StatsStorage) -> None:
        self._handler.storage = storage

    def start(self) -> "UIServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()


class RemoteUIStatsStorageRouter:
    """Client-side router POSTing records to a remote UIServer (reference
    ``deeplearning4j-core/.../impl/RemoteUIStatsStorageRouter.java``)."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout

    def put_record(self, report: StatsReport) -> None:
        req = Request(self.url, data=json.dumps(report.to_dict()).encode(),
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=self.timeout) as resp:
            resp.read()
