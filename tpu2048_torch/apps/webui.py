"""Single-page web UI (vanilla JS, no dependencies).

Functional parity with the reference Dash layout (SURVEY §2 "Web
application"): seven modes, board pane with score/moves/next-move
header, speed gauge with pause/resume, training-params form, log
window with clear/download, training chart, admin file manager, and
arrow-key play — rendered client-side from the JSON API.
"""

INDEX_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>tpu2048 — TPU-native 2048 RL</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 0; background: #19191f;
        color: #e8e8e8; }
 header { padding: 10px 18px; background: #23232d; display: flex;
          gap: 8px; align-items: center; flex-wrap: wrap; }
 header h1 { font-size: 18px; margin: 0 18px 0 0; color: #8fd460; }
 button { background: #32323f; color: #e8e8e8; border: 1px solid #4a4a5a;
          border-radius: 6px; padding: 7px 12px; cursor: pointer; }
 button:hover { background: #41415a; }
 button.active { background: #5a8f3c; border-color: #8fd460; }
 main { display: flex; gap: 18px; padding: 18px; flex-wrap: wrap; }
 .pane { background: #23232d; border-radius: 10px; padding: 14px; }
 #board { display: grid; grid-template-columns: repeat(4, 86px);
          grid-gap: 8px; padding: 8px; background: #2e2e3a;
          border-radius: 8px; }
 .cell { width: 86px; height: 86px; border-radius: 6px; display: flex;
         align-items: center; justify-content: center; font-size: 24px;
         font-weight: 700; color: #fff; background: #3a3a48; }
 #hdr { margin: 0 0 10px; font-size: 15px; min-height: 20px; }
 #logs { white-space: pre-wrap; font-family: ui-monospace, monospace;
         font-size: 12px; height: 420px; overflow-y: auto; width: 440px;
         background: #14141a; padding: 10px; border-radius: 6px; }
 label { font-size: 13px; display: block; margin: 7px 0 2px; }
 input, select { background: #14141a; border: 1px solid #4a4a5a;
         color: #e8e8e8; border-radius: 5px; padding: 6px; width: 170px; }
 #chart { background: #14141a; border-radius: 6px; }
 table { font-size: 13px; border-collapse: collapse; }
 td { padding: 4px 10px; border-bottom: 1px solid #32323f; }
 a { color: #8fd460; }
 .row { display: flex; gap: 10px; align-items: center; margin: 8px 0; }
 #guide { max-width: 680px; line-height: 1.5; font-size: 14px;
          max-height: 560px; overflow-y: auto; }
 #guide pre { background: #14141a; padding: 8px; border-radius: 6px;
          overflow-x: auto; font-size: 12px; }
 #guide code { background: #14141a; padding: 1px 4px; border-radius: 4px;
          font-size: 13px; }
</style>
</head>
<body>
<header>
 <h1>tpu2048</h1>
 <span id="modes"></span>
</header>
<main>
 <div class="pane" id="board-pane">
   <div id="hdr">Welcome! Choose a mode of action.</div>
   <div id="board"></div>
   <div class="row" id="speed-row" style="display:none">
     <label style="margin:0">speed</label>
     <input type="range" id="speed" min="30" max="1000" value="200"
            style="width:140px">
     <button id="pause">pause</button>
     <button id="stopwatch" style="display:none">stop</button>
   </div>
   <div class="row" id="play-controls" style="display:none">
     <button data-dir="0">&#8592;</button>
     <button data-dir="1">&#8593;</button>
     <button data-dir="2">&#8594;</button>
     <button data-dir="3">&#8595;</button>
     <button id="restart">restart</button>
     <span style="font-size:12px">(arrow keys work too)</span>
   </div>
 </div>
 <div class="pane" id="controls"></div>
 <div class="pane" id="log-pane" style="display:none">
   <div class="row">
     <b>logs</b>
     <button id="clear-logs">clear</button>
     <a id="dl-logs" download="logs.txt">download</a>
   </div>
   <div id="logs"></div>
 </div>
 <div class="pane" id="chart-pane" style="display:none">
   <b>training history (ma-100 score)</b><br><br>
   <canvas id="chart" width="460" height="260"></canvas>
 </div>
</main>
<script>
const COLORS = {0:'#3a3a48',1:'#c62828',2:'#d81b60',3:'#8e24aa',
 4:'#5e35b1',5:'#1e88e5',6:'#00897b',7:'#7cb342',8:'#43a047',
 9:'#fb8c00',10:'#f4511e',11:'#6d4c41',12:'#e53935',13:'#d07878',
 14:'#9c27b0',15:'#673ab7',16:'#ef5350'};
const DIRS = {0:'left',1:'up',2:'right',3:'down'};
let mode = null, playSession = null, watchSession = null;
let frames = [], framePos = 0, paused = false, logKey = null;
let timer = null, trainAgent = null;

const $ = id => document.getElementById(id);
const api = async (path, opts) => {
  const r = await fetch(path, opts);
  const j = await r.json();
  if (!r.ok) throw new Error(j.error || r.status);
  return j;
};
const post = (path, body) => api(path, {method:'POST',
  headers:{'Content-Type':'application/json'}, body:JSON.stringify(body||{})});

function drawBoard(board) {
  const el = $('board'); el.innerHTML = '';
  for (const row of board) for (const v of row) {
    const d = document.createElement('div');
    d.className = 'cell';
    d.style.background = COLORS[v] || '#ef5350';
    d.textContent = v ? (1 << v) : '';
    if ((1<<v) > 8192) d.style.fontSize = '18px';
    el.appendChild(d);
  }
}
function drawFrame(f, selfPlay) {
  drawBoard(f.board);
  let h = `Score = ${f.score} &nbsp; Moves = ${f.odometer} &nbsp; `;
  if (f.next_move === -1) h += '<b>Game over!</b>';
  else if (!selfPlay && f.next_move >= 0) h += `Next move = ${DIRS[f.next_move]}`;
  $('hdr').innerHTML = h;
}
drawBoard([[0,0,0,0],[0,0,0,0],[0,0,0,0],[0,0,0,0]]);

async function setMode(m) {
  mode = m;
  clearInterval(timer); timer = null; frames = []; framePos = 0;
  document.querySelectorAll('#modes button').forEach(b =>
    b.classList.toggle('active', b.dataset.m === m));
  $('speed-row').style.display = ['watch','replay'].includes(m) ? 'flex' : 'none';
  $('stopwatch').style.display = m === 'watch' ? 'inline' : 'none';
  $('play-controls').style.display = m === 'play' ? 'flex' : 'none';
  $('log-pane').style.display = ['train','test'].includes(m) ? 'block' : 'none';
  $('chart-pane').style.display = m === 'train' ? 'block' : 'none';
  const toast = document.getElementById('play-toast');
  if (toast) toast.style.display = m === 'play' ? 'block' : 'none';
  const c = $('controls'); c.innerHTML = '';
  if (m === 'guide') renderGuide();
  if (m === 'train') await renderTrain();
  if (m === 'test') await renderTest();
  if (m === 'watch') await renderWatch();
  if (m === 'replay') await renderReplay();
  if (m === 'play') await startPlay();
  if (m === 'admin') await renderAdmin();
}

// minimal markdown renderer: headers, bold/italic/code, lists, tables
function mdToHtml(md) {
  const esc = s => s.replace(/&/g,'&amp;').replace(/</g,'&lt;')
                    .replace(/>/g,'&gt;');
  const inline = s => esc(s)
    .replace(/`([^`]+)`/g, '<code>$1</code>')
    .replace(/\*\*([^*]+)\*\*/g, '<b>$1</b>')
    .replace(/\*([^*]+)\*/g, '<i>$1</i>')
    .replace(/\[([^\]]+)\]\(([^)]+)\)/g, '<a href="$2">$1</a>');
  const lines = md.split('\n');
  let html = '', inList = false, inCode = false, tbl = null;
  const flushTbl = () => {
    if (!tbl) return;
    html += '<table>' + tbl.map((r, i) =>
      '<tr>' + r.map(c => i ? `<td>${inline(c)}</td>`
                            : `<td><b>${inline(c)}</b></td>`).join('') +
      '</tr>').join('') + '</table>';
    tbl = null;
  };
  for (const ln of lines) {
    if (ln.startsWith('```')) {
      flushTbl();
      html += inCode ? '</pre>' : '<pre>'; inCode = !inCode; continue;
    }
    if (inCode) { html += esc(ln) + '\n'; continue; }
    if (/^\s*\|/.test(ln)) {
      const cells = ln.replace(/^\s*\||\|\s*$/g, '').split('|')
        .map(c => c.trim());
      if (cells.every(c => /^[-: ]+$/.test(c))) continue;
      (tbl = tbl || []).push(cells);
      continue;
    }
    flushTbl();
    if (inList && !/^\s*[-*] /.test(ln)) { html += '</ul>'; inList = false; }
    const h = ln.match(/^(#{1,4}) (.*)/);
    if (h) { html += `<h${h[1].length+1}>${inline(h[2])}</h${h[1].length+1}>`; }
    else if (/^\s*[-*] /.test(ln)) {
      if (!inList) { html += '<ul>'; inList = true; }
      html += `<li>${inline(ln.replace(/^\s*[-*] /, ''))}</li>`;
    }
    else if (ln.trim() === '') html += '<br>';
    else html += inline(ln) + '\n';
  }
  if (inList) html += '</ul>';
  flushTbl();
  return html;
}

async function renderGuide() {
  let docs = {};
  try { docs = await api('/api/guide'); } catch (e) {}
  const tabs = [['guide','User guide'],['project','Project'],
                ['design','Design']].filter(t => docs[t[0]]);
  $('controls').innerHTML = `<div class="row">` +
    tabs.map(t => `<button data-doc="${t[0]}">${t[1]}</button>`).join('') +
    `</div><div id="guide"></div>`;
  const show = k => {
    $('guide').innerHTML = mdToHtml(docs[k] || '');
    document.querySelectorAll('[data-doc]').forEach(b =>
      b.classList.toggle('active', b.dataset.doc === k));
  };
  document.querySelectorAll('[data-doc]').forEach(b =>
    b.onclick = () => show(b.dataset.doc));
  if (tabs.length) show(tabs[0][0]);
}

async function agentOptions() {
  const agents = await api('/api/agents');
  return agents.map(a => `<option>${a}</option>`).join('');
}

async function renderTrain() {
  const spec = await api('/api/params');
  const opts = await agentOptions();
  let html = `<h3>Train Agent</h3>
   <label>agent</label>
   <select id="t-mode"><option value="new">new agent</option>
   <option value="existing">continue existing</option>
   <option value="fork">fork existing (carry weights)</option></select>
   <span id="t-existing" style="display:none"><label>existing agent</label>
   <select id="t-agent">${opts}</select></span>
   <span id="t-source" style="display:none"><label>source agent</label>
   <select id="t-src">${opts}</select></span>`;
  for (const p of spec) {
    if (p.type === 'select')
      html += `<label>${p.name}</label><select id="p-${p.name}">` +
        p.options.map(o => `<option ${o==p.default?'selected':''}>${o}</option>`)
        .join('') + '</select>';
    else
      html += `<label>${p.name}</label><input id="p-${p.name}"
        value="${p.default}" ${p.type==='number'?'type="number"':''}
        ${p.step?`step="${p.step}"`:''}>`;
  }
  html += `<div class="row"><button id="t-start">TRAIN</button>
    <button id="t-stop">STOP</button><span id="t-status"></span></div>`;
  $('controls').innerHTML = html;
  // continue-existing prefill: fill the form with the agent's current
  // hyperparameters (reference precedence: agent attrs > saved config
  // > defaults — application.py:537-552), so the user inspects and
  // retunes what the agent actually runs with before resuming.
  const prefill = async () => {
    const name = $('t-agent').value;
    if (!name) return;
    try {
      const info = await api('/api/agent?name=' + encodeURIComponent(name));
      for (const p of spec) {
        const el = $('p-' + p.name);
        if (el && info.form[p.name] !== undefined)
          el.value = info.form[p.name];
      }
      $('t-status').textContent =
        `loaded ${name}: ${info.meta.episodes || 0} episodes trained`;
    } catch (e) { $('t-status').textContent = e.message; }
  };
  $('t-mode').onchange = () => {
    const m = $('t-mode').value;
    $('t-existing').style.display = m === 'existing' ? 'inline' : 'none';
    $('t-source').style.display = m === 'fork' ? 'inline' : 'none';
    if (m === 'existing') prefill();
  };
  $('t-agent').onchange = prefill;
  $('t-start').onclick = async () => {
    const params = {};
    for (const p of spec) {
      const v = $('p-' + p.name).value;
      params[p.name] = (p.type === 'text' || p.type === 'select' &&
        isNaN(Number(v))) ? v : Number(v);
    }
    const tm = $('t-mode').value;
    if (tm === 'existing') params.name = $('t-agent').value;
    const source = tm === 'fork' ? $('t-src').value : null;
    try {
      const r = await post('/api/train/start',
        {params, new_agent: tm !== 'existing', parent: 'web',
         source_agent: source});
      logKey = r.log; trainAgent = params.name;
      $('t-status').textContent = 'training...';
      pollLogs(); pollChart();
    } catch (e) { $('t-status').textContent = e.message; }
  };
  $('t-stop').onclick = async () => {
    if (trainAgent) await post('/api/train/stop', {name: trainAgent});
    $('t-status').textContent = 'stopped';
  };
}

async function renderTest() {
  const opts = await agentOptions();
  $('controls').innerHTML = `<h3>Test Agent</h3>
   <label>agent</label><select id="e-agent">${opts}
   <option value="@random">baseline: random moves</option>
   <option value="@score">baseline: score-greedy</option></select>
   <label>games</label><input id="e-num" type="number" value="100">
   <label>depth</label><input id="e-depth" type="number" value="0">
   <label>width</label><input id="e-width" type="number" value="1">
   <label>since_empty</label><input id="e-se" type="number" value="6">
   <div class="row"><button id="e-start">LAUNCH!</button>
   <button id="e-stop">STOP</button><span id="e-status"></span></div>`;
  $('e-start').onclick = async () => {
    const sel = $('e-agent').value;
    const isBase = sel.startsWith('@');
    try {
      const r = await post('/api/test/start', {
        name: isBase ? '' : sel, policy: isBase ? sel.slice(1) : null,
        num: +$('e-num').value, depth: +$('e-depth').value,
        width: +$('e-width').value, since_empty: +$('e-se').value});
      logKey = r.log; $('e-status').textContent = 'running...'; pollLogs();
    } catch (e) { $('e-status').textContent = e.message; }
  };
  $('e-stop').onclick = () => {
    const sel = $('e-agent').value;
    post('/api/test/stop',
         {name: sel.startsWith('@') ? sel.slice(1) : sel});
  };
}

async function renderWatch() {
  const opts = await agentOptions();
  $('controls').innerHTML = `<h3>Watch Agent</h3>
   <label>agent</label><select id="w-agent">${opts}</select>
   <label>depth</label><input id="w-depth" type="number" value="0">
   <label>width</label><input id="w-width" type="number" value="1">
   <label>since_empty</label><input id="w-se" type="number" value="6">
   <label>engine</label><select id="w-backend">
   <option value="auto">auto</option><option value="native">native C++</option>
   <option value="device">TPU device search</option>
   <option value="python">reference-parity python</option></select>
   <div class="row"><button id="w-start">LAUNCH!</button>
   <span id="w-status"></span></div>`;
  $('w-start').onclick = async () => {
    try {
      const r = await post('/api/watch/start', {name: $('w-agent').value,
        depth: +$('w-depth').value, width: +$('w-width').value,
        since_empty: +$('w-se').value, backend: $('w-backend').value});
      watchSession = r.session; frames = []; framePos = 0; paused = false;
      $('w-status').textContent = 'watching';
      startAnimator(async () => {
        const r2 = await api(`/api/watch/frames?session=${watchSession}` +
          `&since=${frames.length}`);
        frames.push(...r2.frames);
        return r2.done;
      });
    } catch (e) { $('w-status').textContent = e.message; }
  };
  $('stopwatch').onclick = () => {
    if (watchSession) post('/api/watch/stop', {session: watchSession});
  };
}

async function renderReplay() {
  const games = await api('/api/games');
  $('controls').innerHTML = `<h3>Replay Game</h3>
   <label>game</label><select id="r-game">` +
   games.map(g => `<option>${g}</option>`).join('') + `</select>
   <div class="row"><button id="r-start">REPLAY</button>
   <span id="r-status"></span></div>`;
  $('r-start').onclick = async () => {
    try {
      frames = await api(`/api/replay?name=` +
        encodeURIComponent($('r-game').value));
      framePos = 0; paused = false;
      $('r-status').textContent = `${frames.length} frames`;
      startAnimator(async () => true);
    } catch (e) { $('r-status').textContent = e.message; }
  };
}

function startAnimator(feeder) {
  clearInterval(timer);
  const tick = async () => {
    try { await feeder(); } catch (e) {}
    if (!paused && framePos < frames.length) {
      drawFrame(frames[framePos]); framePos++;
    }
  };
  timer = setInterval(tick, +$('speed').value);
  $('speed').oninput = () => {
    clearInterval(timer); timer = setInterval(tick, +$('speed').value);
  };
}
$('pause').onclick = () => {
  paused = !paused;
  $('pause').textContent = paused ? 'resume' : 'pause';
};

async function startPlay() {
  const f = await post('/api/play/new');
  playSession = f.session;
  drawFrame(f, true);
  $('controls').innerHTML = `<h3>Play Yourself</h3>
    <p style="font-size:13px;max-width:240px">Use the arrow keys or the
    buttons under the board. R restarts.</p>`;
  showPlayToast();
}
// Draggable "Game instructions" toast — the reference ships this as a
// clientside callback (assets/play_instruction_draggable.js:1-47,
// registered at application.py:888-892); here it is a plain floating
// div moved by pointer events, dismissable, shown only in play mode.
function showPlayToast() {
  let t = document.getElementById('play-toast');
  if (!t) {
    t = document.createElement('div');
    t.id = 'play-toast';
    t.style.cssText = 'position:fixed;top:70px;right:24px;z-index:50;' +
      'background:#2c2c38;border:1px solid #4a4a5a;border-radius:8px;' +
      'width:230px;box-shadow:0 4px 14px rgba(0,0,0,.45);' +
      'font-size:13px;user-select:none';
    t.innerHTML = `<div id="play-toast-bar" style="cursor:move;padding:6px
      10px;background:#3a3a4a;border-radius:8px 8px 0 0;display:flex;
      justify-content:space-between"><b>Game instructions</b>
      <span id="play-toast-x" style="cursor:pointer;padding:0 4px">&times;
      </span></div>
      <div style="padding:8px 10px">Join the numbers and get to the
      <b>2048</b> tile! Use the arrow keys (or the buttons under the
      board) to move the tiles. When two tiles with the same number
      touch, they merge into one. Press <b>R</b> to restart. Drag this
      note anywhere by its title bar.</div>`;
    document.body.appendChild(t);
    document.getElementById('play-toast-x').onclick =
      () => { t.style.display = 'none'; };
    const bar = document.getElementById('play-toast-bar');
    let drag = null;
    bar.addEventListener('pointerdown', e => {
      const r = t.getBoundingClientRect();
      drag = {dx: e.clientX - r.left, dy: e.clientY - r.top};
      t.style.right = 'auto';
      bar.setPointerCapture(e.pointerId);
    });
    bar.addEventListener('pointermove', e => {
      if (!drag) return;
      t.style.left = Math.max(0, e.clientX - drag.dx) + 'px';
      t.style.top = Math.max(0, e.clientY - drag.dy) + 'px';
    });
    bar.addEventListener('pointerup', () => { drag = null; });
  }
  t.style.display = 'block';
}
async function playMove(dir) {
  if (!playSession || mode !== 'play') return;
  const f = await post('/api/play/move',
    {session: playSession, direction: dir});
  drawFrame(f, true);
}
document.addEventListener('keydown', e => {
  const map = {ArrowLeft:0, ArrowUp:1, ArrowRight:2, ArrowDown:3};
  if (mode === 'play' && e.key in map) {
    e.preventDefault(); playMove(map[e.key]);
  }
  if (mode === 'play' && (e.key === 'r' || e.key === 'R')) startPlay();
});
document.addEventListener('click', e => {
  if (e.target.dataset && e.target.dataset.dir !== undefined &&
      e.target.dataset.dir !== '')
    playMove(+e.target.dataset.dir);
});
$('restart') && ($('restart').onclick = startPlay);

function pollLogs() {
  const f = async () => {
    if (!logKey) return;
    try {
      const r = await api(`/api/logs?key=${encodeURIComponent(logKey)}`);
      const el = $('logs');
      el.textContent = r.text;
      el.scrollTop = el.scrollHeight;
      $('dl-logs').href = 'data:text/plain;charset=utf-8,' +
        encodeURIComponent(r.text);
    } catch (e) {}
  };
  f(); clearInterval(window._logTimer); window._logTimer = setInterval(f, 1000);
}
$('clear-logs').onclick = async () => {
  if (logKey) { await post('/api/logs/clear', {key: logKey}); }
};

function pollChart() {
  const f = async () => {
    if (!trainAgent) return;
    try {
      const r = await api(`/api/chart?name=${trainAgent}`);
      const cv = $('chart'), ctx = cv.getContext('2d');
      ctx.clearRect(0, 0, cv.width, cv.height);
      if (!r.y.length) return;
      const maxY = Math.max(...r.y) * 1.05, n = r.y.length;
      ctx.strokeStyle = '#8fd460'; ctx.lineWidth = 2; ctx.beginPath();
      r.y.forEach((v, i) => {
        const x = 30 + (cv.width - 40) * i / Math.max(n - 1, 1);
        const y = cv.height - 20 - (cv.height - 40) * v / maxY;
        i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
      });
      ctx.stroke();
      ctx.fillStyle = '#888'; ctx.font = '11px monospace';
      ctx.fillText(Math.round(maxY), 2, 14);
      ctx.fillText(`${n * 100} eps`, cv.width - 70, cv.height - 4);
    } catch (e) {}
  };
  f(); clearInterval(window._chartTimer);
  window._chartTimer = setInterval(f, 5000);
}

async function renderAdmin() {
  const files = await api('/api/files');
  let stats = {now: {}, history: ''};
  try { stats = await api('/api/stats'); } catch (e) {}
  const n = stats.now || {};
  let html = `<h3>Admin</h3>
   <div style="font-size:13px;margin-bottom:8px">
     <b>memory</b>: rss ${n.rss_mb ?? '?'} MiB` +
   (n.hbm_in_use_mb !== undefined ?
     ` &nbsp; hbm ${n.hbm_in_use_mb}${n.hbm_limit_mb ?
       ' / ' + n.hbm_limit_mb : ''} MiB (${n.device || ''})` : '') +
   `</div>` +
   (stats.history ? `<details style="font-size:12px;margin-bottom:8px">
     <summary>memory history</summary>
     <pre style="max-height:140px;overflow:auto">${stats.history}</pre>
     </details>` : '') +
   `<h4 style="margin:8px 0 4px">Stored files</h4>
   <div class="row"><input type="file" id="up-file">
   <select id="up-kind"><option value="c/">config (c/)</option>
     <option value="g/">game (g/)</option>
     <option value="a/">agent (a/)</option>
     <option value="weights/">weights (weights/)</option>
     <option value="l/">log (l/)</option></select>
   <input id="up-key" placeholder="name (default: file name)">
   <button id="up-btn">upload</button></div><table>`;
  for (const f of files)
    html += `<tr><td><a href="/api/files/${encodeURIComponent(f)}"
      download>${f}</a></td>
      <td><button data-del="${f}">delete</button></td></tr>`;
  $('controls').innerHTML = html + '</table>';
  document.querySelectorAll('[data-del]').forEach(b => b.onclick =
    async () => {
      await fetch('/api/files/' + encodeURIComponent(b.dataset.del),
                  {method: 'DELETE'});
      renderAdmin();
    });
  $('up-btn').onclick = async () => {
    const file = $('up-file').files[0];
    if (!file) return;
    // the namespace prefix comes from the chosen kind, like the
    // reference's upload (application.py:259-299); a name containing
    // "/" is taken as a full key (advanced use)
    const name = $('up-key').value || file.name;
    const key = name.includes('/') ? name : $('up-kind').value + name;
    await fetch('/api/files/' + encodeURIComponent(key),
                {method: 'PUT', body: await file.arrayBuffer()});
    renderAdmin();
  };
}

(async () => {
  const modes = await api('/api/modes');
  $('modes').innerHTML = modes.map(m =>
    `<button data-m="${m.id}">${m.label}</button>`).join('');
  document.querySelectorAll('#modes button').forEach(b =>
    b.onclick = () => setMode(b.dataset.m));
  setInterval(() => post('/api/heartbeat', {parent: 'web'}), 60000);
  setMode('guide');
})();
</script>
</body>
</html>
"""
