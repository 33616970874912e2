/**
 * Node.js binding for the STARK framework.
 *
 * Mirrors the reference's N-API package surface
 * (`/root/reference/packages/napi/src/index.ts:8-48`: prove / verify /
 * proveWithFilePath / verifyWithFilePath) with the reference's IN-PROCESS
 * call semantics restored: the first call spawns ONE
 * long-lived Python worker (`python -m stark_tpu.cli serve`, JSON-RPC over
 * stdio) that holds the compiled executables and circuit caches, so every
 * later call pays only the proof itself instead of a full process + JAX
 * init + compile-cache load.
 *
 * The four core exports return Promises (the worker is asynchronous by
 * nature); `proveSync`/`verifySync`-style one-shot subprocess variants are
 * kept for scripts that need the old blocking behavior.
 */
"use strict";

const { execFileSync, spawn } = require("child_process");
const fs = require("fs");
const os = require("os");
const path = require("path");
const readline = require("readline");

const PYTHON = process.env.STARK_TPU_PYTHON || "python3";
const ENV = { ...process.env, PYTHONPATH: path.join(__dirname, "..", "..") };

// ---------------------------------------------------------------------------
// persistent worker
// ---------------------------------------------------------------------------

let worker = null; // { child, pending: Map<id, {resolve, reject}>, nextId, ready }

function ensureWorker() {
  if (worker && worker.child.exitCode === null) return worker.ready;
  const child = spawn(PYTHON, ["-m", "stark_tpu.cli", "serve"], {
    stdio: ["pipe", "pipe", "inherit"],
    env: ENV,
  });
  const pending = new Map();
  let readyResolve;
  const ready = new Promise((res) => (readyResolve = res));
  worker = { child, pending, nextId: 1, ready };

  const rl = readline.createInterface({ input: child.stdout });
  rl.on("line", (line) => {
    if (!line.startsWith("RPC ")) return; // stray library print
    const msg = JSON.parse(line.slice(4));
    if (msg.id === null && msg.result && msg.result.event === "ready") {
      readyResolve();
      return;
    }
    const p = pending.get(msg.id);
    if (!p) return;
    pending.delete(msg.id);
    if (msg.error) {
      p.reject(new Error(`${msg.error.type}: ${msg.error.message}`));
    } else {
      p.resolve(msg.result);
    }
  });
  child.on("exit", (code) => {
    for (const [, p] of pending) {
      p.reject(new Error(`stark-tpu worker exited with code ${code}`));
    }
    pending.clear();
  });
  return ready;
}

function call(method, params) {
  return ensureWorker().then(
    () =>
      new Promise((resolve, reject) => {
        const id = worker.nextId++;
        worker.pending.set(id, { resolve, reject });
        worker.child.stdin.write(JSON.stringify({ id, method, params }) + "\n");
      })
  );
}

/** Stop the shared worker (idempotent; a later call respawns it). */
function shutdown() {
  if (!worker || worker.child.exitCode !== null) return Promise.resolve();
  const w = worker;
  worker = null;
  return new Promise((resolve) => {
    w.child.on("exit", () => resolve());
    w.child.stdin.write(JSON.stringify({ id: 0, method: "shutdown" }) + "\n");
    setTimeout(() => w.child.kill(), 10_000).unref();
  });
}

// ---------------------------------------------------------------------------
// the reference napi surface (async, worker-backed)
// ---------------------------------------------------------------------------

/** Prove from file paths; writes the proof JSON to proofJsonPath. */
function proveWithFilePath(r1csPath, wtnsPath, proofJsonPath) {
  return call("prove", {
    r1cs: r1csPath,
    wtns: wtnsPath,
    proof_json: proofJsonPath,
  }).then(() => undefined);
}

/** Verify a proof JSON against the circuit + witness file paths. */
function verifyWithFilePath(r1csPath, wtnsPath, proofJsonPath) {
  return call("verify", {
    r1cs: r1csPath,
    wtns: wtnsPath,
    proof_json: proofJsonPath,
  }).then((r) => {
    if (!r.verified) throw new Error("proof verification failed");
  });
}

function withTempFiles(files, fn) {
  const dir = fs.mkdtempSync(path.join(os.tmpdir(), "stark-tpu-"));
  try {
    const paths = {};
    for (const [name, content] of Object.entries(files)) {
      paths[name] = path.join(dir, name);
      if (content !== null) fs.writeFileSync(paths[name], content);
    }
    return fn(paths, () => fs.rmSync(dir, { recursive: true, force: true }));
  } catch (e) {
    fs.rmSync(dir, { recursive: true, force: true });
    throw e;
  }
}

/** Prove from in-memory buffers; resolves to the proof JSON string. */
function prove(r1csBuffer, wtnsBuffer) {
  return withTempFiles(
    { "c.r1cs": r1csBuffer, "c.wtns": wtnsBuffer },
    (p, cleanup) =>
      call("prove", { r1cs: p["c.r1cs"], wtns: p["c.wtns"], inline: true })
        .then((r) => r.proof)
        .finally(cleanup)
  );
}

/** Verify an in-memory proof JSON string; resolves true or rejects. */
function verify(r1csBuffer, wtnsBuffer, proofJson) {
  return withTempFiles(
    { "c.r1cs": r1csBuffer, "c.wtns": wtnsBuffer, "proof.json": proofJson },
    (p, cleanup) =>
      call("verify", {
        r1cs: p["c.r1cs"],
        wtns: p["c.wtns"],
        proof_json: p["proof.json"],
      })
        .then((r) => {
          if (!r.verified) throw new Error("proof verification failed");
          return true;
        })
        .finally(cleanup)
  );
}

/** Precompile every prover/verifier executable for a circuit (parallel;
 * fills the persistent compile cache ahead of serving traffic). */
function warmup(r1csPath) {
  return call("warmup", { r1cs: r1csPath }).then((r) => r.warmed);
}

// ---------------------------------------------------------------------------
// one-shot blocking variants (fresh subprocess per call, like round 2)
// ---------------------------------------------------------------------------

function runSync(args) {
  execFileSync(PYTHON, ["-m", "stark_tpu.cli", ...args], {
    stdio: ["ignore", "inherit", "inherit"],
    env: ENV,
  });
}

function proveWithFilePathSync(r1csPath, wtnsPath, proofJsonPath) {
  runSync(["prove", r1csPath, wtnsPath, proofJsonPath]);
}

function verifyWithFilePathSync(r1csPath, wtnsPath, proofJsonPath) {
  runSync(["verify", r1csPath, wtnsPath, proofJsonPath]);
}

module.exports = {
  prove,
  verify,
  proveWithFilePath,
  verifyWithFilePath,
  warmup,
  shutdown,
  proveWithFilePathSync,
  verifyWithFilePathSync,
};
