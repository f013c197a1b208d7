#!/usr/bin/env bash
# Multi-process / multi-host train launcher of the port (the JAX package's
# bin/cluster_optimizer.sh; reference surface: bin/cluster_optimizer.sh:
# 55-79, CommMaster and the per-host slave fan-out). The rendezvous is
# torch.distributed's TCP store: rank 0's host serves it, and every rank
# joins with --coordinator/--num-processes/--process-id. With
# YTK_SLAVE_HOSTS unset, every rank forks locally (several workers on one
# host, each on its --device); set YTK_SLAVE_HOSTS="host1 host2 ..." to
# launch ranks 1..N-1 over ssh. Extra arguments pass through to
# `python -m ytklearn_tpu_torch.cli train` (e.g. --set, --device cpu,
# --hist-precision int8). PYTHON names the interpreter (default python).
#
#   ytklearn_tpu_torch/bin/cluster_optimizer.sh <model> <config> <num_processes> [train args...]
#
# Master log: every rank's output is rank-labelled and appended to one
# merged log (YTK_MASTER_LOG, default <repo>/log/master.log), the
# counterpart of the reference's comm.info/error forwarding to the
# CommMaster log (`tail -f log/master.log | grep "train loss"`). Remote
# ranks need no extra plumbing: their output rides the ssh pipe.
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:${PYTHONPATH}}"
python_bin="${PYTHON:-python}"

model_name="${1:?usage: cluster_optimizer.sh <model> <config> <num_processes> [train args...]}"
properties_path="${2:?usage: cluster_optimizer.sh <model> <config> <num_processes> [train args...]}"
num_procs="${3:?usage: cluster_optimizer.sh <model> <config> <num_processes> [train args...]}"
shift 3

read -r -a slave_hosts <<<"${YTK_SLAVE_HOSTS:-}"
coordinator_host="${YTK_COORDINATOR_HOST:-127.0.0.1}"
coordinator_port="${YTK_COORDINATOR_PORT:-29401}"
if ((${#slave_hosts[@]} > 0)) && [[ "${coordinator_host}" == "127.0.0.1" ]]; then
  echo "error: YTK_SLAVE_HOSTS is set but YTK_COORDINATOR_HOST is the" >&2
  echo "loopback default — remote ranks would dial themselves. Set" >&2
  echo "YTK_COORDINATOR_HOST to a host reachable from every slave." >&2
  exit 2
fi
coordinator="${coordinator_host}:${coordinator_port}"

master_log="${YTK_MASTER_LOG:-${REPO_ROOT}/log/master.log}"
mkdir -p "$(dirname "${master_log}")"
: >"${master_log}"
echo "master log: ${master_log}" >&2

# rank-label stdin lines and append to the master log; line-buffered so
# concurrent appenders stay line-atomic (O_APPEND writes <= PIPE_BUF)
label() {
  awk -v tag="$1" '{ print "[" tag "] " $0; fflush() }' >>"${master_log}"
}

pids=()
cleanup() {
  for pid in "${pids[@]:-}"; do
    kill "${pid}" 2>/dev/null || true
  done
}
trap cleanup EXIT

for ((rank = num_procs - 1; rank >= 0; rank--)); do
  cmd=("${python_bin}" -m ytklearn_tpu_torch.cli train "${model_name}"
       "${properties_path}" --coordinator "${coordinator}"
       --num-processes "${num_procs}" --process-id "${rank}" "$@")
  if ((rank == 0)); then
    # rank 0 in the foreground: it serves the rendezvous and prints the
    # result on stdout; its log (stderr) is tee'd into the master log and
    # kept on the console
    "${cmd[@]}" 2> >(tee >(label "rank 0") >&2)
  elif ((${#slave_hosts[@]} > 0)); then
    host="${slave_hosts[$(((rank - 1) % ${#slave_hosts[@]}))]}"
    remote_cmd="$(printf '%q ' "${cmd[@]}")"
    ssh "${host}" "cd $(printf '%q' "${REPO_ROOT}") && PYTHONPATH=$(printf '%q' "${REPO_ROOT}") ${remote_cmd}" \
      > >(label "rank ${rank}") 2>&1 &
    pids+=($!)
  else
    "${cmd[@]}" > >(label "rank ${rank}") 2>&1 &
    pids+=($!)
  fi
done
# wait for each pid alone: `wait p1 p2` reports only the last status,
# which would swallow a crashed rank
rc=0
for pid in "${pids[@]}"; do
  if ! wait "${pid}"; then
    rc=1
  fi
done
pids=()  # a clean exit: nothing left for the trap to kill
# drain the process-substitution log writers (label/tee) so the master
# log is whole before exit: bash >= 5.1 waits for them on a bare wait;
# the mtime poll bounds the wait on an older bash
wait
for _ in 1 2 3 4 5 6 7 8 9 10; do
  m1="$(stat -c %Y "${master_log}" 2>/dev/null || stat -f %m "${master_log}")"
  sleep 0.2
  m2="$(stat -c %Y "${master_log}" 2>/dev/null || stat -f %m "${master_log}")"
  [[ "${m1}" == "${m2}" ]] && break
done
exit "${rc}"
