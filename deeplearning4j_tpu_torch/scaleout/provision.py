"""Counterpart of ``deeplearning4j_tpu/scaleout/provision.py``, copied (no
framework in it): cluster provisioning, the pod analogue of the
reference's EC2 tooling.

Parity with ref: aws/ec2/provision/ (Ec2BoxCreator creates worker VMs,
HostProvisioner uploads and runs per host, ClusterSetup provisions all
hosts then launches master/workers, DistributedDeepLearningTrainer is the
CLI entry). The AWS SDK/JSch calls become:

- TpuPodCreator: builds the ``gcloud compute tpus tpu-vm`` command lines
  a pod needs (create/delete/describe), the same lines as the JAX
  package's. Commands are GENERATED and returned; execution goes through
  a pluggable runner so tests (and zero-egress environments) assert the
  exact commands without any cloud call, the same reason the reference
  isolates provisioning behind interfaces it mocks in tests.
- HostProvisioner: per-host upload-and-run over a command runner
  (production: subprocess ``gcloud ... ssh/scp``; tests: recording fake).
- ClusterSetup: provisions every worker host in parallel and emits the
  multihost launch commands; the ``DL4J_COORDINATOR`` /
  ``DL4J_NUM_PROCESSES`` / ``DL4J_PROCESS_ID`` wiring is what the port's
  ``parallel/multihost.initialize()`` reads.

Nothing here calls a cloud unless a caller runs the commands.
"""

from __future__ import annotations

import shlex
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

# runner: takes argv, returns (exit_code, stdout). Injectable for tests.
CommandRunner = Callable[[List[str]], "tuple[int, str]"]


def subprocess_runner(argv: List[str]) -> "tuple[int, str]":
    proc = subprocess.run(argv, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


@dataclass
class TpuPodSpec:
    """What to provision (ref: Ec2BoxCreator fields — ami/size/securityGroup
    become their TPU equivalents)."""

    name: str = "dl4j-tpu"
    accelerator_type: str = "v5litepod-8"
    zone: str = "us-central1-a"
    project: Optional[str] = None
    runtime_version: str = "tpu-ubuntu2204-base"
    num_hosts: int = 1  # v5litepod-8 = 1 host; a v5litepod-256 = 32 hosts
    labels: Dict[str, str] = field(default_factory=dict)


class TpuPodCreator:
    """Generates + optionally executes pod lifecycle commands
    (ref: Ec2BoxCreator.create/blowupBoxes)."""

    def __init__(self, spec: TpuPodSpec,
                 runner: CommandRunner = subprocess_runner):
        self.spec = spec
        self.runner = runner

    def _base(self) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm"]
        return cmd

    def _common_flags(self) -> List[str]:
        flags = [f"--zone={self.spec.zone}"]
        if self.spec.project:
            flags.append(f"--project={self.spec.project}")
        return flags

    def create_command(self) -> List[str]:
        cmd = self._base() + ["create", self.spec.name] + self._common_flags()
        cmd += [f"--accelerator-type={self.spec.accelerator_type}",
                f"--version={self.spec.runtime_version}"]
        if self.spec.labels:
            kv = ",".join(f"{k}={v}" for k, v in sorted(self.spec.labels.items()))
            cmd.append(f"--labels={kv}")
        return cmd

    def delete_command(self) -> List[str]:
        return self._base() + ["delete", self.spec.name, "--quiet"] + self._common_flags()

    def describe_command(self) -> List[str]:
        return self._base() + ["describe", self.spec.name] + self._common_flags()

    def create(self) -> "tuple[int, str]":
        return self.runner(self.create_command())

    def destroy(self) -> "tuple[int, str]":
        return self.runner(self.delete_command())


class HostProvisioner:
    """Upload + run on one pod host (ref: HostProvisioner.uploadAndRun /
    runRemoteCommand / uploadForDeployment, minus the JSch key plumbing —
    gcloud owns auth)."""

    def __init__(self, pod: str, worker: int = 0, zone: str = "us-central1-a",
                 project: Optional[str] = None,
                 runner: CommandRunner = subprocess_runner):
        self.pod = pod
        self.worker = worker
        self.zone = zone
        self.project = project
        self.runner = runner

    def _flags(self) -> List[str]:
        flags = [f"--zone={self.zone}", f"--worker={self.worker}"]
        if self.project:
            flags.append(f"--project={self.project}")
        return flags

    def run_remote_command(self, remote_command: str) -> "tuple[int, str]":
        argv = (["gcloud", "compute", "tpus", "tpu-vm", "ssh", self.pod]
                + self._flags() + [f"--command={remote_command}"])
        return self.runner(argv)

    def upload_for_deployment(self, src: str, dest: str) -> "tuple[int, str]":
        argv = (["gcloud", "compute", "tpus", "tpu-vm", "scp", src,
                 f"{self.pod}:{dest}"] + self._flags())
        return self.runner(argv)

    def upload_and_run(self, script: str, root_dir: str = "~") -> "tuple[int, str]":
        code, out = self.upload_for_deployment(script, root_dir)
        if code != 0:
            return code, out
        base = script.rsplit("/", 1)[-1]
        # leave a leading ~ unquoted so the remote shell tilde-expands it
        if root_dir == "~" or root_dir.startswith("~/"):
            cd = "~" + shlex.quote(root_dir[1:]) if len(root_dir) > 1 else "~"
        else:
            cd = shlex.quote(root_dir)
        return self.run_remote_command(f"cd {cd} && bash {shlex.quote(base)}")


class ClusterSetup:
    """Provision every host then emit/launch the multihost training command
    (ref: ClusterSetup.exec — provisions master then workers in parallel via
    ActorSystem futures; here a thread pool)."""

    def __init__(self, spec: TpuPodSpec, train_argv: Sequence[str],
                 coordinator_port: int = 8476,
                 runner: CommandRunner = subprocess_runner):
        self.spec = spec
        self.train_argv = list(train_argv)
        self.coordinator_port = coordinator_port
        self.runner = runner

    def launch_command(self, process_id: int, coordinator_host: str) -> str:
        """Per-host training launch wiring the env parallel/multihost.py
        initialize() reads."""
        env = (f"DL4J_COORDINATOR={coordinator_host}:{self.coordinator_port} "
               f"DL4J_NUM_PROCESSES={self.spec.num_hosts} "
               f"DL4J_PROCESS_ID={process_id}")
        return env + " " + " ".join(shlex.quote(a) for a in self.train_argv)

    def provision_hosts(self, setup_script: str,
                        max_parallel: int = 8) -> List["tuple[int, str]"]:
        provs = [
            HostProvisioner(self.spec.name, worker=i, zone=self.spec.zone,
                            project=self.spec.project, runner=self.runner)
            for i in range(self.spec.num_hosts)
        ]
        with ThreadPoolExecutor(max_workers=max_parallel) as ex:
            return list(ex.map(lambda p: p.upload_and_run(setup_script), provs))

    def exec(self, setup_script: str, coordinator_host: str = "localhost"
             ) -> List["tuple[int, str]"]:
        """Provision all hosts, then start training on each
        (ref: ClusterSetup.exec). If ANY host fails provisioning, no launch
        is attempted — a partial multihost job would hang the
        DL4J_NUM_PROCESSES rendezvous on the healthy hosts."""
        results = self.provision_hosts(setup_script)
        failed = [i for i, (code, _) in enumerate(results) if code != 0]
        if failed:
            raise RuntimeError(
                f"provisioning failed on hosts {failed}; aborting launch. "
                f"Outputs: {[results[i][1][-500:] for i in failed]}")
        launches = []
        for i in range(self.spec.num_hosts):
            prov = HostProvisioner(self.spec.name, worker=i,
                                   zone=self.spec.zone,
                                   project=self.spec.project,
                                   runner=self.runner)
            launches.append(
                prov.run_remote_command(self.launch_command(i, coordinator_host)))
        return results + launches
