"""Fleet provisioning: GPU host setup command generation (port of
``provision.py``).

Reference ``deeplearning4j-aws`` (SURVEY.md §2.4): ``ec2/provision/
ClusterSetup.java`` boots an EC2 fleet and ``s3/`` moves artifacts.  A
``ClusterSpec`` describes the host, ``TpuClusterSetup`` emits (and
optionally executes) the exact ``gcloud`` commands, and
``StorageTransfer`` wraps ``gsutil`` for the S3-uploader role.  Command
generation is pure (testable, zero-egress); execution is explicit
opt-in (``execute=True``), mirroring the reference's side-effecting
provisioner.

The deliberate difference from the JAX module: the port runs on an
NVIDIA H100, so the commands create a Compute Engine VM with the card
(``gcloud compute instances``, machine type ``a3-highgpu-1g``: one H100
80GB) instead of a Cloud TPU slice (``gcloud compute tpus tpu-vm``).
The class names stay the JAX package's.  ``StorageTransfer``'s commands
do not depend on the device and equal the JAX package's.
"""
from __future__ import annotations

import shlex
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["ClusterSpec", "TpuClusterSetup", "StorageTransfer"]

# the VM image project of ``ClusterSpec.runtime_version``'s families
_IMAGE_PROJECT = "deeplearning-platform-release"
_BOOT_DISK = "200GB"


@dataclass
class ClusterSpec:
    """One GPU host description (the EC2 fleet-spec role), with the JAX
    package's fields: ``accelerator_type`` is the machine type, whose
    family carries the card (``a3-highgpu-1g``: one H100 80GB), and
    ``runtime_version`` the VM image family."""
    name: str
    zone: str = "us-central1-a"
    accelerator_type: str = "a3-highgpu-1g"
    runtime_version: str = "pytorch-latest-gpu"
    project: Optional[str] = None
    preemptible: bool = False
    network: Optional[str] = None
    tags: Dict[str, str] = field(default_factory=dict)


class TpuClusterSetup:
    """Generate/execute provisioning commands (reference
    ``ClusterSetup.java`` — its ``provision()`` boots the fleet; here
    ``apply()`` only runs when ``execute=True``).  The JAX package's name,
    for a GPU host."""

    def __init__(self, spec: ClusterSpec):
        self.spec = spec

    def _base(self) -> List[str]:
        return ["gcloud", "compute", "instances"]

    def create_command(self) -> List[str]:
        s = self.spec
        cmd = self._base() + ["create", s.name, f"--zone={s.zone}",
                              f"--machine-type={s.accelerator_type}",
                              f"--image-family={s.runtime_version}",
                              f"--image-project={_IMAGE_PROJECT}",
                              f"--boot-disk-size={_BOOT_DISK}",
                              # a VM with a GPU cannot live-migrate
                              "--maintenance-policy=TERMINATE"]
        if s.project:
            cmd.append(f"--project={s.project}")
        if s.preemptible:
            cmd.append("--provisioning-model=SPOT")
        if s.network:
            cmd.append(f"--network={s.network}")
        if s.tags:
            # gcloud --labels is a dict flag: repeating it overrides, so
            # all pairs must go in one comma-joined occurrence
            pairs = ",".join(f"{k}={v}" for k, v in sorted(s.tags.items()))
            cmd.append(f"--labels={pairs}")
        return cmd

    def delete_command(self) -> List[str]:
        s = self.spec
        cmd = self._base() + ["delete", s.name, f"--zone={s.zone}",
                              "--quiet"]
        if s.project:
            cmd.append(f"--project={s.project}")
        return cmd

    def ssh_command(self, worker: str = "all",
                    remote_command: Optional[str] = None) -> List[str]:
        """``gcloud compute ssh`` to the host.  ``worker`` keeps the JAX
        signature: a GPU host is one VM, so only "all" and "0" name it."""
        if worker not in ("all", "0"):
            raise ValueError(f"worker {worker!r}: a GPU host is one VM "
                             "(worker 'all' or '0')")
        s = self.spec
        cmd = ["gcloud", "compute", "ssh", s.name, f"--zone={s.zone}"]
        if remote_command:
            cmd += ["--command", remote_command]
        return cmd

    def describe_command(self) -> List[str]:
        s = self.spec
        return self._base() + ["describe", s.name, f"--zone={s.zone}"]

    def render(self) -> str:
        """The full provisioning script as shell text (audit artifact)."""
        return "\n".join(shlex.join(c) for c in (
            self.create_command(), self.describe_command()))

    def apply(self, execute: bool = False, timeout: float = 600):
        """Run the create command.  execute=False (default) returns the
        command without side effects."""
        cmd = self.create_command()
        if not execute:
            return cmd
        return subprocess.run(cmd, check=True, capture_output=True,
                              timeout=timeout)


class StorageTransfer:
    """gsutil up/down-loader (reference ``aws/s3/uploader``)."""

    def __init__(self, bucket: str):
        if not bucket.startswith("gs://"):
            bucket = f"gs://{bucket}"
        self.bucket = bucket.rstrip("/")

    def upload_command(self, local_path: str, remote_key: str) -> List[str]:
        return ["gsutil", "-m", "cp", "-r", local_path,
                f"{self.bucket}/{remote_key}"]

    def download_command(self, remote_key: str, local_path: str) -> List[str]:
        return ["gsutil", "-m", "cp", "-r",
                f"{self.bucket}/{remote_key}", local_path]

    def run(self, cmd: List[str], execute: bool = False, timeout: float = 600):
        if not execute:
            return cmd
        return subprocess.run(cmd, check=True, capture_output=True,
                              timeout=timeout)
