"""ACL policy documents.

Behavioral reference: `acl/policy.go` — HCL policies of the shape

    namespace "default" {
      policy = "read"                       # coarse level
      capabilities = ["submit-job", ...]    # fine-grained
    }
    node     { policy = "read" }
    agent    { policy = "write" }
    operator { policy = "read" }
    quota    { policy = "read" }
    host_volume "prod-*" { policy = "write" }

Coarse levels expand to capability sets exactly as `expandNamespacePolicy`
does (policy.go:92): read → list/read caps; write → read + mutating caps;
scale → scaling caps. `deny` wins over everything.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..jobspec.hcl import HclError, parse_hcl

# namespace capabilities (acl/policy.go NamespaceCapability*)
CAP_DENY = "deny"
CAP_LIST_JOBS = "list-jobs"
CAP_READ_JOB = "read-job"
CAP_SUBMIT_JOB = "submit-job"
CAP_DISPATCH_JOB = "dispatch-job"
CAP_READ_LOGS = "read-logs"
CAP_READ_FS = "read-fs"
CAP_ALLOC_EXEC = "alloc-exec"
CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
CAP_ALLOC_NODE_EXEC = "alloc-node-exec"
CAP_LIST_SCALING_POLICIES = "list-scaling-policies"
CAP_READ_SCALING_POLICY = "read-scaling-policy"
CAP_READ_JOB_SCALING = "read-job-scaling"
CAP_SCALE_JOB = "scale-job"
CAP_CSI_REGISTER_PLUGIN = "csi-register-plugin"
CAP_CSI_WRITE_VOLUME = "csi-write-volume"
CAP_CSI_READ_VOLUME = "csi-read-volume"
CAP_CSI_LIST_VOLUME = "csi-list-volume"
CAP_CSI_MOUNT_VOLUME = "csi-mount-volume"
CAP_SENTINEL_OVERRIDE = "sentinel-override"
# built-in secrets engine (the Vault-analog KV; no reference caps — the
# reference delegates secrets ACL to Vault's own policies)
CAP_SECRETS_READ = "secrets-read"
CAP_SECRETS_WRITE = "secrets-write"

NAMESPACE_CAPABILITIES = {
    CAP_DENY, CAP_LIST_JOBS, CAP_READ_JOB, CAP_SUBMIT_JOB, CAP_DISPATCH_JOB,
    CAP_READ_LOGS, CAP_READ_FS, CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE,
    CAP_ALLOC_NODE_EXEC, CAP_LIST_SCALING_POLICIES, CAP_READ_SCALING_POLICY,
    CAP_READ_JOB_SCALING, CAP_SCALE_JOB, CAP_CSI_REGISTER_PLUGIN,
    CAP_CSI_WRITE_VOLUME, CAP_CSI_READ_VOLUME, CAP_CSI_LIST_VOLUME,
    CAP_CSI_MOUNT_VOLUME, CAP_SENTINEL_OVERRIDE,
    CAP_SECRETS_READ, CAP_SECRETS_WRITE,
}
CAPABILITIES = NAMESPACE_CAPABILITIES

_READ_CAPS = [CAP_LIST_JOBS, CAP_READ_JOB, CAP_CSI_LIST_VOLUME,
              CAP_CSI_READ_VOLUME, CAP_READ_JOB_SCALING,
              CAP_LIST_SCALING_POLICIES, CAP_READ_SCALING_POLICY]
_WRITE_CAPS = _READ_CAPS + [
    CAP_SUBMIT_JOB, CAP_DISPATCH_JOB, CAP_READ_LOGS, CAP_READ_FS,
    CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE, CAP_CSI_WRITE_VOLUME,
    CAP_CSI_MOUNT_VOLUME, CAP_SCALE_JOB,
    CAP_SECRETS_READ, CAP_SECRETS_WRITE,
]
_SCALE_CAPS = [CAP_READ_JOB_SCALING, CAP_LIST_SCALING_POLICIES,
               CAP_READ_SCALING_POLICY, CAP_SCALE_JOB]

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
POLICY_SCALE = "scale"
POLICY_LIST = "list"  # node-only (reference NodePolicy list)

_COARSE = {POLICY_DENY, POLICY_READ, POLICY_WRITE, POLICY_SCALE}


def expand_namespace_policy(level: str) -> List[str]:
    """acl/policy.go expandNamespacePolicy."""
    if level == POLICY_DENY:
        return [CAP_DENY]
    if level == POLICY_READ:
        return list(_READ_CAPS)
    if level == POLICY_WRITE:
        return list(_WRITE_CAPS)
    if level == POLICY_SCALE:
        return list(_SCALE_CAPS)
    raise HclError(f"invalid namespace policy {level!r}")


@dataclass
class NamespaceRule:
    name: str = "default"
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)


@dataclass
class HostVolumeRule:
    name: str = "*"
    policy: str = ""


@dataclass
class Policy:
    namespaces: List[NamespaceRule] = field(default_factory=list)
    host_volumes: List[HostVolumeRule] = field(default_factory=list)
    node: str = ""      # "" | deny | read | write | list
    agent: str = ""
    operator: str = ""
    quota: str = ""
    plugin: str = ""


def parse_policy(src: str) -> Policy:
    """acl/policy.go Parse: HCL → validated Policy."""
    tree = parse_hcl(src)
    p = Policy()
    for blk in _blocks(tree.get("namespace")):
        (name, body), = blk.items() if _labeled(blk) else (("default", blk),)
        rule = NamespaceRule(name=name)
        rule.policy = body.get("policy", "")
        if rule.policy and rule.policy not in _COARSE:
            raise HclError(f"invalid policy {rule.policy!r} "
                           f"for namespace {name!r}")
        rule.capabilities = list(body.get("capabilities", []))
        for cap in rule.capabilities:
            if cap not in NAMESPACE_CAPABILITIES:
                raise HclError(f"invalid capability {cap!r}")
        if rule.policy:
            rule.capabilities = list(dict.fromkeys(
                expand_namespace_policy(rule.policy) + rule.capabilities))
        p.namespaces.append(rule)
    for blk in _blocks(tree.get("host_volume")):
        (name, body), = blk.items() if _labeled(blk) else (("*", blk),)
        level = body.get("policy", "")
        if level and level not in (POLICY_DENY, POLICY_READ, POLICY_WRITE):
            raise HclError(f"invalid host_volume policy {level!r}")
        p.host_volumes.append(HostVolumeRule(name=name, policy=level))
    for scope in ("node", "agent", "operator", "quota", "plugin"):
        blk = tree.get(scope)
        if blk is None:
            continue
        body = _blocks(blk)[0]
        level = body.get("policy", "")
        allowed = {POLICY_DENY, POLICY_READ, POLICY_WRITE}
        if scope == "node":
            allowed.add(POLICY_LIST)
        if level not in allowed:
            raise HclError(f"invalid {scope} policy {level!r}")
        setattr(p, scope, level)
    return p


def _blocks(v) -> List[dict]:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _labeled(blk: dict) -> bool:
    # A labeled block decodes as {label: {body...}} — structurally: one
    # key whose value is a dict. Rule bodies never have dict-valued keys
    # (policy is a string, capabilities a list), so this is unambiguous
    # even for a namespace literally named "policy".
    return len(blk) == 1 and isinstance(next(iter(blk.values())), dict)
