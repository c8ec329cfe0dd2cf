"""Compiled ACL capability matcher.

Behavioral reference: `acl/acl.go` (ACL :43, NewACL :86 merging policies,
AllowNamespaceOperation :214, namespace glob resolution — when no exact
rule matches, the glob rule with the LONGEST non-wildcard prefix (fewest
wildcard chars, reference uses most-characters-matched) wins; coarse
scopes: node/agent/operator/quota/plugin with deny > write > list/read).
Management ACLs bypass every check.
"""
from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional

from .policy import (CAP_DENY, POLICY_DENY, POLICY_LIST, POLICY_READ,
                     POLICY_WRITE, Policy)


class ACLError(Exception):
    """Permission denied (endpoints map this to 403)."""


_LEVEL_ORDER = {POLICY_DENY: 3, POLICY_WRITE: 2, POLICY_READ: 1,
                POLICY_LIST: 0.5, "": 0}


def _merge_level(cur: str, new: str) -> str:
    # deny always wins; otherwise the broader grant wins (acl.go maxPrivilege)
    if POLICY_DENY in (cur, new):
        return POLICY_DENY
    return new if _LEVEL_ORDER[new] > _LEVEL_ORDER[cur] else cur


class ACL:
    def __init__(self, management: bool = False) -> None:
        self.management = management
        # exact/glob namespace → capability set
        self._namespaces: Dict[str, set] = {}
        self._host_volumes: Dict[str, str] = {}
        self.node = ""
        self.agent = ""
        self.operator = ""
        self.quota = ""
        self.plugin = ""

    @classmethod
    def from_policies(cls, policies: List[Policy]) -> "ACL":
        acl = cls()
        for p in policies:
            for rule in p.namespaces:
                caps = acl._namespaces.setdefault(rule.name, set())
                if CAP_DENY in rule.capabilities:
                    caps.clear()
                    caps.add(CAP_DENY)
                elif CAP_DENY not in caps:
                    caps.update(rule.capabilities)
            for hv in p.host_volumes:
                acl._host_volumes[hv.name] = _merge_level(
                    acl._host_volumes.get(hv.name, ""), hv.policy)
            for scope in ("node", "agent", "operator", "quota", "plugin"):
                level = getattr(p, scope)
                if level:
                    setattr(acl, scope,
                            _merge_level(getattr(acl, scope), level))
        return acl

    # ---- namespace capabilities (acl.go AllowNamespaceOperation :214) ----

    def _namespace_caps(self, namespace: str) -> set:
        caps = self._namespaces.get(namespace)
        if caps is not None:
            return caps
        # glob resolution: the matching pattern with the most literal
        # characters wins (acl.go findClosestMatchingGlob)
        best, best_score = None, -1
        for pattern, pcaps in self._namespaces.items():
            if fnmatch.fnmatchcase(namespace, pattern):
                score = len(pattern.replace("*", "").replace("?", ""))
                if score > best_score:
                    best, best_score = pcaps, score
        return best if best is not None else set()

    def allow_namespace_operation(self, namespace: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._namespace_caps(namespace)
        if CAP_DENY in caps:
            return False
        return cap in caps

    def allow_namespace(self, namespace: str) -> bool:
        """Any grant at all in the namespace (acl.go AllowNamespace)."""
        if self.management:
            return True
        caps = self._namespace_caps(namespace)
        return bool(caps) and CAP_DENY not in caps

    # ---- host volumes ----

    def allow_host_volume_operation(self, volume: str, write: bool) -> bool:
        if self.management:
            return True
        best, best_score = "", -1
        for pattern, level in self._host_volumes.items():
            if fnmatch.fnmatchcase(volume, pattern):
                score = len(pattern.replace("*", "").replace("?", ""))
                if score > best_score:
                    best, best_score = level, score
        if best == POLICY_DENY:
            return False
        return best == POLICY_WRITE if write else best in (POLICY_READ,
                                                           POLICY_WRITE)

    # ---- coarse scopes (acl.go AllowNodeRead/Write etc.) ----

    def _allow(self, level: str, write: bool, allow_list: bool = False
               ) -> bool:
        if self.management:
            return True
        if level == POLICY_DENY:
            return False
        if write:
            return level == POLICY_WRITE
        if allow_list and level == POLICY_LIST:
            return True
        return level in (POLICY_READ, POLICY_WRITE)

    def allow_node_read(self) -> bool:
        return self._allow(self.node, write=False, allow_list=True)

    def allow_node_write(self) -> bool:
        return self._allow(self.node, write=True)

    def allow_agent_read(self) -> bool:
        return self._allow(self.agent, write=False)

    def allow_agent_write(self) -> bool:
        return self._allow(self.agent, write=True)

    def allow_operator_read(self) -> bool:
        return self._allow(self.operator, write=False)

    def allow_operator_write(self) -> bool:
        return self._allow(self.operator, write=True)

    def allow_quota_read(self) -> bool:
        return self._allow(self.quota, write=False)

    def allow_quota_write(self) -> bool:
        return self._allow(self.quota, write=True)

    def allow_plugin_read(self) -> bool:
        return self._allow(self.plugin, write=False)


def management_acl() -> ACL:
    return ACL(management=True)
