"""Graph visualizer: embedded HTTP server + force-directed subgraph view.

Parity with the reference's visualizer stack — the embedded httpserver +
d3 front end (utils/visualizer/GraphVisualizer.java:25-48) and its handler
suite (utils/visualizer/handlers/: SubGraphHandler, SearchHandler-style
on-demand neighborhood queries), plus the commands that drive it
(commands/visualizer/: VisualCortex starts the server against a graph,
SendToVisualizer posts subgraphs).  The front end is a self-contained
canvas force layout with coverage-scaled nodes, per-color edges, hover
tooltips, a kmer search box (server-side neighborhood DFS when the server
was started with a graph), and a sample legend.

Endpoints:
  GET  /            the page
  GET  /graph       current subgraph JSON {name, vertices, edges, samples}
  GET  /stats       graph summary (records, colors, samples, k)
  GET  /search?kmer=...&radius=N   neighborhood subgraph around a kmer
  POST /            replace the displayed subgraph (SendToVisualizer)
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><title>corticall_tpu graph</title>
<style>body{font-family:sans-serif;margin:0;overflow:hidden}
#info{position:absolute;top:8px;left:8px;background:#fffc;padding:6px 10px;
border-radius:6px;font-size:13px;max-width:420px}
#legend span{display:inline-block;margin-right:10px}
#legend i{display:inline-block;width:10px;height:10px;border-radius:5px;
margin-right:4px}
#tip{position:absolute;display:none;background:#222c;color:#fff;
padding:4px 8px;border-radius:4px;font-size:12px;pointer-events:none}
input{width:260px}</style></head>
<body><div id="info">
 <b>corticall_tpu visualizer</b> &mdash; drag to pan, wheel to zoom,
 hover for kmer details<br>
 <span id="name"></span> <span id="counts"></span><br>
 <form id="sf">seed kmer: <input id="q" placeholder="search neighborhood">
 radius <input id="r" value="25" size="3" style="width:40px"></form>
 <div id="legend"></div>
</div>
<div id="tip"></div>
<canvas id="c"></canvas>
<script>
const canvas=document.getElementById('c');const ctx=canvas.getContext('2d');
canvas.width=innerWidth;canvas.height=innerHeight;
let nodes=[],links=[],tx=0,ty=0,scale=1,samples=[];
const palette=['#4269d0','#efb118','#ff725c','#6cc5b0','#3ca951','#ff8ab7'];
function load(g){
  nodes=[];links=[];const idx={};samples=g.samples||[];
  (g.vertices||[]).forEach((v,i)=>{idx[v.id]=i;
    nodes.push({id:v.id,label:v.kmer,copy:v.copy||0,cov:v.cov||[],
      novel:v.novel||false,deg:v.deg||0,
      x:canvas.width/2+Math.random()*200-100,
      y:canvas.height/2+Math.random()*200-100,vx:0,vy:0});});
  (g.edges||[]).forEach(e=>links.push({s:idx[e.source],t:idx[e.target],
    color:e.color||0}));
  document.getElementById('name').textContent=g.name||'';
  document.getElementById('counts').textContent=
    `${nodes.length} vertices, ${links.length} edges`;
  document.getElementById('legend').innerHTML=samples.map((s,i)=>
    `<span><i style="background:${palette[i%palette.length]}"></i>${s}</span>`
  ).join('')+'<span><i style="background:#d00"></i>novel</span>';
}
fetch('/graph').then(r=>r.json()).then(g=>{load(g);tick();});
document.getElementById('sf').onsubmit=e=>{e.preventDefault();
  const q=document.getElementById('q').value.trim();
  const r=document.getElementById('r').value||25;
  fetch(`/search?kmer=${q}&radius=${r}`).then(x=>x.json()).then(load);};
function maxcov(n){return n.cov.length?Math.max(...n.cov):0}
function tick(){
  for(let it=0;it<3;it++){
    links.forEach(l=>{const a=nodes[l.s],b=nodes[l.t];
      const dx=b.x-a.x,dy=b.y-a.y,d=Math.hypot(dx,dy)||1,f=(d-24)*0.02;
      a.vx+=f*dx/d;a.vy+=f*dy/d;b.vx-=f*dx/d;b.vy-=f*dy/d;});
    for(let i=0;i<nodes.length;i++)for(let j=i+1;j<nodes.length;j++){
      const a=nodes[i],b=nodes[j];const dx=b.x-a.x,dy=b.y-a.y;
      const d2=dx*dx+dy*dy+1;if(d2<4000){const f=120/d2;
        a.vx-=f*dx;a.vy-=f*dy;b.vx+=f*dx;b.vy+=f*dy;}}
    nodes.forEach(n=>{n.x+=n.vx*=0.85;n.y+=n.vy*=0.85;});}
  ctx.setTransform(1,0,0,1,0,0);ctx.clearRect(0,0,canvas.width,canvas.height);
  ctx.setTransform(scale,0,0,scale,tx,ty);
  links.forEach(l=>{ctx.strokeStyle=palette[l.color%palette.length]+'88';
    ctx.beginPath();ctx.moveTo(nodes[l.s].x,nodes[l.s].y);
    ctx.lineTo(nodes[l.t].x,nodes[l.t].y);ctx.stroke();});
  nodes.forEach(n=>{
    const r=3+Math.min(6,Math.sqrt(maxcov(n)));
    ctx.fillStyle=n.novel?'#d00':palette[0];
    ctx.beginPath();ctx.arc(n.x,n.y,r,0,7);ctx.fill();
    if(n.deg>2){ctx.strokeStyle='#000';ctx.stroke();}});
  requestAnimationFrame(tick);}
let drag=null;const tip=document.getElementById('tip');
canvas.onmousedown=e=>drag={x:e.clientX-tx,y:e.clientY-ty};
canvas.onmousemove=e=>{
  if(drag){tx=e.clientX-drag.x;ty=e.clientY-drag.y;return;}
  const mx=(e.clientX-tx)/scale,my=(e.clientY-ty)/scale;
  const n=nodes.find(n=>(n.x-mx)**2+(n.y-my)**2<64);
  if(n){tip.style.display='block';tip.style.left=(e.clientX+12)+'px';
    tip.style.top=(e.clientY+12)+'px';
    tip.textContent=`${n.label} copy=${n.copy} cov=[${n.cov}]`
      +(n.novel?' NOVEL':'');}
  else tip.style.display='none';};
canvas.onmouseup=()=>drag=null;
canvas.onwheel=e=>{scale*=e.deltaY<0?1.1:0.9;e.preventDefault();};
</script></body></html>"""


def subgraph_to_json(g, graph=None, rois=None, name: str = "") -> dict:
    """Subgraph -> d3-style {vertices, edges} payload, enriched with
    per-color coverage / degree / novel flags when the backing CortexGraph
    (and optional ROI set) are given (SubGraphHandler equivalent)."""
    roi_set = rois if rois is not None else set()
    verts = []
    ids = {}
    for i, v in enumerate(g.vertices()):
        ids[v] = i
        row = {"id": i, "kmer": v.kmer, "copy": v.copy, "index": v.index}
        if graph is not None:
            rec = graph.find_record(v.kmer)
            if rec >= 0:
                row["cov"] = [int(c) for c in graph.coverages[rec]]
                e = 0
                for c in range(graph.num_colors):
                    e |= int(graph.edges[rec, c])
                row["deg"] = bin(e & 0xF).count("1") + bin(e >> 4).count("1")
        row["novel"] = v.canonical in roi_set
        verts.append(row)
    edges = [{"source": ids[u], "target": ids[v], "color": c}
             for u in g.vertices() for v, c in g.out_edges(u)]
    out = {"name": name, "vertices": verts, "edges": edges}
    if graph is not None:
        out["samples"] = list(graph.sample_names)
    return out


class GraphVisualizer:
    """Embedded server (GraphVisualizer.java:25-48 / VisualCortex).  With a
    backing graph, /search serves on-demand neighborhood subgraphs."""

    def __init__(self, port: int = 0, graph=None, rois=None):
        self._payload = {"vertices": [], "edges": []}
        self.graph = graph
        self.rois = ({rois.kmer_string(i) for i in range(rois.num_records)}
                     if rois is not None and hasattr(rois, "num_records")
                     else rois)

        viz = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path == "/graph":
                    self._send(json.dumps(viz._payload).encode(),
                               "application/json")
                elif url.path == "/stats":
                    self._send(json.dumps(viz.stats()).encode(),
                               "application/json")
                elif url.path == "/search":
                    q = urllib.parse.parse_qs(url.query)
                    kmer = (q.get("kmer") or [""])[0].upper()
                    radius = int((q.get("radius") or ["25"])[0])
                    try:
                        payload = viz.search(kmer, radius)
                        self._send(json.dumps(payload).encode(),
                                   "application/json")
                    except Exception as e:
                        self._send(json.dumps({"error": str(e)}).encode(),
                                   "application/json", 400)
                else:
                    self._send(_PAGE.encode(), "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                viz._payload = json.loads(self.rfile.read(n))
                self._send(b"ok", "text/plain")

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    # -- handlers ----------------------------------------------------------
    def stats(self) -> dict:
        g = self.graph
        if g is None:
            return {"records": 0, "colors": 0, "samples": [], "k": 0}
        return {"records": g.num_records, "colors": g.num_colors,
                "samples": list(g.sample_names), "k": g.kmer_size,
                "novel": len(self.rois) if self.rois else 0}

    def search(self, kmer: str, radius: int = 25) -> dict:
        """Bounded-radius neighborhood DFS around a kmer — the on-demand
        subgraph query the reference serves per request."""
        if self.graph is None:
            raise ValueError("server started without a graph")
        if self.graph.find_record(kmer) < 0:
            raise ValueError(f"kmer not in graph: {kmer}")
        from .traversal import TraversalConfig, TraversalEngine
        from .traversal.stopping import ExplorationStopper
        e = TraversalEngine(TraversalConfig(
            graph=self.graph, traversal_colors=list(range(self.graph.num_colors)),
            stopping_rule=ExplorationStopper, max_branch_length=radius))
        sub = e.dfs(kmer)
        return subgraph_to_json(sub, self.graph, self.rois,
                                name=f"neighborhood of {kmer} (r={radius})")

    def display(self, subgraph, name: str = "") -> None:
        """Replace the displayed graph (GraphVisualizer.display equivalent)."""
        self._payload = subgraph_to_json(subgraph, self.graph, self.rois,
                                         name=name)

    def shutdown(self) -> None:
        self.server.shutdown()
