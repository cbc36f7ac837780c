// Desktop shell: spawn the aegis_tpu REST server as a child process and load
// the SPA it serves.  Mirrors the reference Electron flow (index.js spawns
// aegis_api.py, kills it on quit) — here the renderer IS the SPA at
// serve/static/index.html, so no separate renderer bundle is needed.
"use strict";

const { app, BrowserWindow } = require("electron");
const { spawn } = require("child_process");
const http = require("http");

const PORT = 8508;
let serverProc = null;

function startServer() {
  const python = process.env.AEGIS_PYTHON || "python3";
  serverProc = spawn(python, ["-m", "aegis_tpu.serve.server"], {
    cwd: `${__dirname}/..`,
    stdio: ["ignore", "inherit", "inherit"],
  });
  serverProc.on("exit", (code) => {
    console.log(`aegis server exited (${code})`);
    serverProc = null;
  });
}

function waitForServer(retries = 60) {
  return new Promise((resolve, reject) => {
    const tick = (left) => {
      http
        .get({ host: "127.0.0.1", port: PORT, path: "/api/presets" }, () =>
          resolve()
        )
        .on("error", () => {
          if (left <= 0) return reject(new Error("server did not start"));
          setTimeout(() => tick(left - 1), 500);
        });
    };
    tick(retries);
  });
}

async function createWindow() {
  startServer();
  try {
    await waitForServer();
  } catch (e) {
    console.error(e.message);
  }
  const win = new BrowserWindow({
    width: 1280,
    height: 860,
    title: "Aegis Studio",
    backgroundColor: "#0e1016",
  });
  win.loadURL(`http://127.0.0.1:${PORT}/`);
}

app.whenReady().then(createWindow);

app.on("window-all-closed", () => {
  if (serverProc) serverProc.kill();
  app.quit();
});

app.on("quit", () => {
  if (serverProc) serverProc.kill();
});
