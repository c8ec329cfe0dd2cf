"""ACL tokens + policies: storage and resolution.

Behavioral reference: `nomad/structs` ACLToken/ACLPolicy, the ACL
endpoints (`nomad/acl_endpoint.go` — Bootstrap :64, UpsertPolicies,
UpsertTokens, resolution via `Server.ResolveToken` `nomad/acl.go:38` with
a parsed-policy cache). Tokens are `client` (attached policies) or
`management` (full access); the anonymous token applies when no secret is
presented and ACLs are enabled.
"""
from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .acl import ACL, ACLError, management_acl
from .policy import Policy, parse_policy

TOKEN_TYPE_CLIENT = "client"
TOKEN_TYPE_MANAGEMENT = "management"
ANONYMOUS_TOKEN_ID = "anonymous"


@dataclass
class ACLToken:
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = TOKEN_TYPE_CLIENT
    policies: List[str] = field(default_factory=list)
    global_: bool = False
    create_time: float = 0.0


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    rules: str = ""  # HCL source (reference stores the raw document)


def new_management_token(name: str = "Management Token") -> ACLToken:
    return ACLToken(
        accessor_id=str(uuid.uuid4()), secret_id=str(uuid.uuid4()),
        name=name, type=TOKEN_TYPE_MANAGEMENT, global_=True,
        create_time=time.time(),
    )


class TokenStore:
    """Token/policy tables + resolution cache (nomad/acl.go)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tokens_by_secret: Dict[str, ACLToken] = {}
        self._tokens_by_accessor: Dict[str, ACLToken] = {}
        self._policies: Dict[str, ACLPolicy] = {}
        self._parse_cache: Dict[str, Policy] = {}
        self._acl_cache: Dict[str, ACL] = {}
        # bumped on every cache invalidation: a resolve() that compiled
        # against an older generation must not insert its (possibly
        # pre-revocation) ACL into the cache
        self._cache_gen = 0
        self.bootstrapped = False

    # ---- bootstrap (acl_endpoint.go:64) ----

    def bootstrap(self, token: Optional[ACLToken] = None) -> ACLToken:
        """One-shot management token creation. The token may be
        pre-generated by the caller (the durable/replicated path journals
        it so WAL replay and Raft peers index identical ids)."""
        with self._lock:
            if self.bootstrapped:
                raise ACLError("ACL bootstrap already done")
            if token is None:
                token = new_management_token("Bootstrap Token")
            self._index_token_locked(token)
            self._cache_gen += 1
            self.bootstrapped = True
            return token

    # ---- policies ----

    def upsert_policy(self, policy: ACLPolicy) -> None:
        parse_policy(policy.rules)  # validate before storing
        with self._lock:
            self._policies[policy.name] = policy
            self._parse_cache.pop(policy.name, None)
            self._acl_cache.clear()
            self._cache_gen += 1

    def delete_policy(self, name: str) -> None:
        with self._lock:
            self._policies.pop(name, None)
            self._parse_cache.pop(name, None)
            self._acl_cache.clear()
            self._cache_gen += 1

    def policies(self) -> List[ACLPolicy]:
        with self._lock:
            return list(self._policies.values())

    def policy(self, name: str) -> Optional[ACLPolicy]:
        with self._lock:
            return self._policies.get(name)

    # ---- tokens ----

    def upsert_token(self, token: ACLToken) -> ACLToken:
        with self._lock:
            if not token.accessor_id:
                token.accessor_id = str(uuid.uuid4())
            if not token.secret_id:
                token.secret_id = str(uuid.uuid4())
            if not token.create_time:
                token.create_time = time.time()
            if token.type not in (TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT):
                raise ACLError(f"invalid token type {token.type!r}")
            if token.type == TOKEN_TYPE_CLIENT and not token.policies:
                raise ACLError("client token requires policies")
            self._index_token_locked(token)
            self._acl_cache.pop(token.secret_id, None)
            # invalidate in-flight resolves: without a generation bump, a
            # resolve() that read the pre-rotation token can re-cache it
            # after this pop (lost-invalidation race)
            self._cache_gen += 1
            return token

    def _index_token_locked(self, token: ACLToken) -> None:
        # rotation: drop the previous secret of this accessor so a
        # replaced secret stops resolving
        prev = self._tokens_by_accessor.get(token.accessor_id)
        if prev is not None and prev.secret_id != token.secret_id:
            self._tokens_by_secret.pop(prev.secret_id, None)
            self._acl_cache.pop(prev.secret_id, None)
        self._tokens_by_secret[token.secret_id] = token
        self._tokens_by_accessor[token.accessor_id] = token

    def delete_token(self, accessor_id: str) -> None:
        with self._lock:
            token = self._tokens_by_accessor.pop(accessor_id, None)
            if token is not None:
                self._tokens_by_secret.pop(token.secret_id, None)
                self._acl_cache.pop(token.secret_id, None)
                self._cache_gen += 1

    def tokens(self) -> List[ACLToken]:
        with self._lock:
            return list(self._tokens_by_accessor.values())

    def token_by_accessor(self, accessor_id: str) -> Optional[ACLToken]:
        with self._lock:
            return self._tokens_by_accessor.get(accessor_id)

    # ---- resolution (nomad/acl.go ResolveToken) ----

    #: cache key for the anonymous (token-less) ACL
    _ANON_KEY = ""

    def resolve(self, secret_id: Optional[str]) -> ACL:
        """secret → compiled ACL. Unknown secrets are an error; an empty
        secret resolves to the anonymous ACL (no grants unless an
        'anonymous' policy exists)."""
        key = secret_id or self._ANON_KEY
        with self._lock:
            cached = self._acl_cache.get(key)
            if cached is not None:
                return cached
            gen = self._cache_gen
            token = self._tokens_by_secret.get(secret_id) \
                if secret_id else None
        if secret_id and token is None:
            raise ACLError("token not found")
        if token is not None and token.type == TOKEN_TYPE_MANAGEMENT:
            acl = management_acl()
        elif token is not None:
            acl = self._compile(token.policies)
        else:
            acl = self._compile([p.name for p in self.policies()
                                 if p.name == ANONYMOUS_TOKEN_ID])
        with self._lock:
            # lost-invalidation guard: a policy write raced this compile —
            # serve the result once but do not cache it
            if self._cache_gen == gen:
                self._acl_cache[key] = acl
        return acl

    def _compile(self, policy_names: List[str]) -> ACL:
        parsed: List[Policy] = []
        with self._lock:
            for name in policy_names:
                p = self._parse_cache.get(name)
                if p is None:
                    stored = self._policies.get(name)
                    if stored is None:
                        continue  # dangling policy ref: no grants from it
                    p = parse_policy(stored.rules)
                    self._parse_cache[name] = p
                parsed.append(p)
        return ACL.from_policies(parsed)
