"""Twins of the reference's `tests/test_acl.py` (the ACL system and its
HTTP enforcement), run on the port: every agent, server and harness is
the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch.acl import (ACL, ACLError, ACLPolicy, ACLToken, Policy,
                           TokenStore, management_acl, parse_policy)
from nomad_tpu_torch.jobspec.hcl import HclError
from torch_chain_cases import one_torch_thread  # noqa: F401


class TestPolicyParse:
    def test_namespace_coarse_expansion(self):
        p = parse_policy('namespace "default" { policy = "read" }')
        rule = p.namespaces[0]
        assert rule.name == "default"
        assert "read-job" in rule.capabilities
        assert "list-jobs" in rule.capabilities
        assert "submit-job" not in rule.capabilities

    def test_write_includes_read(self):
        p = parse_policy('namespace "apps" { policy = "write" }')
        caps = p.namespaces[0].capabilities
        assert {"read-job", "submit-job", "dispatch-job"} <= set(caps)

    def test_fine_grained_capabilities(self):
        p = parse_policy(
            'namespace "x" { capabilities = ["submit-job", "read-job"] }')
        assert set(p.namespaces[0].capabilities) == {"submit-job",
                                                     "read-job"}

    def test_coarse_scopes(self):
        p = parse_policy(
            'node { policy = "read" }\n'
            'agent { policy = "write" }\n'
            'operator { policy = "read" }\n'
            'quota { policy = "deny" }')
        assert (p.node, p.agent, p.operator, p.quota) == (
            "read", "write", "read", "deny")

    def test_invalid_policy_rejected(self):
        with pytest.raises(HclError):
            parse_policy('namespace "x" { policy = "banana" }')
        with pytest.raises(HclError):
            parse_policy('namespace "x" { capabilities = ["fly"] }')
        with pytest.raises(HclError):
            parse_policy('node { policy = "scale" }')


class TestAclEvaluation:
    def _acl(self, *sources):
        return ACL.from_policies([parse_policy(s) for s in sources])

    def test_namespace_operation(self):
        acl = self._acl('namespace "default" { policy = "read" }')
        assert acl.allow_namespace_operation("default", "read-job")
        assert not acl.allow_namespace_operation("default", "submit-job")
        assert not acl.allow_namespace_operation("other", "read-job")

    def test_glob_longest_match_wins(self):
        acl = self._acl(
            'namespace "*" { policy = "read" }\n'
            'namespace "prod-*" { policy = "deny" }')
        assert acl.allow_namespace_operation("dev", "read-job")
        assert not acl.allow_namespace_operation("prod-api", "read-job")

    def test_merge_is_union_but_deny_wins(self):
        acl = self._acl(
            'namespace "ns" { capabilities = ["read-job"] }',
            'namespace "ns" { capabilities = ["submit-job"] }')
        assert acl.allow_namespace_operation("ns", "read-job")
        assert acl.allow_namespace_operation("ns", "submit-job")
        acl2 = self._acl(
            'namespace "ns" { policy = "write" }',
            'namespace "ns" { policy = "deny" }')
        assert not acl2.allow_namespace_operation("ns", "read-job")

    def test_node_agent_operator(self):
        acl = self._acl('node { policy = "write" }\n'
                        'operator { policy = "read" }')
        assert acl.allow_node_read() and acl.allow_node_write()
        assert acl.allow_operator_read()
        assert not acl.allow_operator_write()
        assert not acl.allow_agent_read()

    def test_host_volume_glob(self):
        acl = self._acl('host_volume "prod-*" { policy = "write" }\n'
                        'host_volume "*" { policy = "read" }')
        assert acl.allow_host_volume_operation("prod-db", write=True)
        assert acl.allow_host_volume_operation("scratch", write=False)
        assert not acl.allow_host_volume_operation("scratch", write=True)

    def test_management_allows_all(self):
        m = management_acl()
        assert m.allow_namespace_operation("any", "submit-job")
        assert m.allow_operator_write()


class TestTokenStore:
    def test_bootstrap_once(self):
        ts = TokenStore()
        tok = ts.bootstrap()
        assert tok.type == "management"
        with pytest.raises(ACLError):
            ts.bootstrap()
        assert ts.resolve(tok.secret_id).management

    def test_client_token_resolution(self):
        ts = TokenStore()
        ts.upsert_policy(ACLPolicy(
            name="readonly",
            rules='namespace "default" { policy = "read" }'))
        tok = ts.upsert_token(ACLToken(name="dev", policies=["readonly"]))
        acl = ts.resolve(tok.secret_id)
        assert acl.allow_namespace_operation("default", "read-job")
        assert not acl.allow_namespace_operation("default", "submit-job")

    def test_unknown_token_rejected(self):
        ts = TokenStore()
        with pytest.raises(ACLError):
            ts.resolve("not-a-secret")

    def test_anonymous_has_no_grants(self):
        ts = TokenStore()
        acl = ts.resolve(None)
        assert not acl.allow_namespace_operation("default", "read-job")

    def test_policy_update_invalidates_cache(self):
        ts = TokenStore()
        ts.upsert_policy(ACLPolicy(
            name="p", rules='namespace "default" { policy = "read" }'))
        tok = ts.upsert_token(ACLToken(policies=["p"]))
        assert ts.resolve(tok.secret_id).allow_namespace_operation(
            "default", "read-job")
        ts.upsert_policy(ACLPolicy(
            name="p", rules='namespace "default" { policy = "deny" }'))
        assert not ts.resolve(tok.secret_id).allow_namespace_operation(
            "default", "read-job")

    def test_bad_policy_rules_rejected(self):
        ts = TokenStore()
        with pytest.raises(HclError):
            ts.upsert_policy(ACLPolicy(name="bad", rules="not { hcl"))


class TestHttpEnforcement:
    @pytest.fixture()
    def secure_agent(self, tmp_path):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import NomadClient

        a = Agent(AgentConfig(client=False, acl_enabled=True,
                              heartbeat_ttl=60.0), device="cpu")
        a.start()
        host, port = a.http_addr
        yield a, host, port
        a.shutdown()

    def test_full_acl_flow_over_http(self, secure_agent):
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.api import ApiError, NomadClient

        a, host, port = secure_agent
        anon = NomadClient(host, port)
        # anonymous is locked out
        with pytest.raises(ApiError) as ei:
            anon.jobs()
        assert ei.value.code == 403
        # bootstrap management token (token-less one-shot)
        boot = anon.acl_bootstrap()
        mgmt = NomadClient(host, port, token=boot.secret_id)
        assert mgmt.jobs() == []
        # second bootstrap rejected
        with pytest.raises(ApiError):
            anon.acl_bootstrap()
        # create read-only policy + client token
        mgmt.acl_upsert_policy(
            "readonly", 'namespace "default" { policy = "read" }\n'
                        'node { policy = "read" }')
        tok = mgmt.acl_create_token(name="ro", policies=["readonly"])
        ro = NomadClient(host, port, token=tok.secret_id)
        assert ro.jobs() == []
        assert ro.nodes() == []
        job = mock.job()
        with pytest.raises(ApiError) as ei:
            ro.register_job(job)
        assert ei.value.code == 403
        with pytest.raises(ApiError):
            ro.system_gc()
        # management can register
        mgmt.register_job(job)
        assert len(ro.jobs()) == 1
        # bad token is an error
        bad = NomadClient(host, port, token="bogus")
        with pytest.raises(ApiError) as ei:
            bad.jobs()
        assert ei.value.code == 403
        # token deletion revokes access
        mgmt.acl_delete_token(tok.accessor_id)
        with pytest.raises(ApiError):
            NomadClient(host, port, token=tok.secret_id).jobs()

    def test_acl_state_survives_restart(self, tmp_path):
        """Tokens/policies ride the WAL like any other table: a restarted
        server still honors issued tokens and refuses re-bootstrap."""
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import ApiError, NomadClient

        data = str(tmp_path / "srv")
        a1 = Agent(AgentConfig(client=False, acl_enabled=True,
                               data_dir=data, heartbeat_ttl=60.0), device="cpu")
        a1.start()
        try:
            anon = NomadClient(*a1.http_addr)
            boot = anon.acl_bootstrap()
            mgmt = NomadClient(a1.http_addr[0], a1.http_addr[1],
                               token=boot.secret_id)
            mgmt.acl_upsert_policy(
                "ro", 'namespace "default" { policy = "read" }')
            tok = mgmt.acl_create_token(name="t", policies=["ro"])
        finally:
            a1.shutdown()

        a2 = Agent(AgentConfig(client=False, acl_enabled=True,
                               data_dir=data, heartbeat_ttl=60.0), device="cpu")
        a2.start()
        try:
            host, port = a2.http_addr
            # both tokens still resolve
            assert NomadClient(host, port,
                               token=boot.secret_id).jobs() == []
            assert NomadClient(host, port,
                               token=tok.secret_id).jobs() == []
            # re-bootstrap still refused
            with pytest.raises(ApiError):
                NomadClient(host, port).acl_bootstrap()
        finally:
            a2.shutdown()

    def test_deployment_action_uses_target_namespace(self, secure_agent):
        """promote/fail authorize against the DEPLOYMENT's namespace, not
        a caller-supplied ?namespace= param."""
        from nomad_tpu_torch.api import ApiError, NomadClient
        from nomad_tpu_torch.structs.deployment import Deployment

        a, host, port = secure_agent
        boot = NomadClient(host, port).acl_bootstrap()
        mgmt = NomadClient(host, port, token=boot.secret_id)
        mgmt.acl_upsert_policy(
            "dev-write", 'namespace "dev" { policy = "write" }')
        tok = mgmt.acl_create_token(name="dev", policies=["dev-write"])
        dev = NomadClient(host, port, token=tok.secret_id)
        d = Deployment(id="dep-prod", namespace="prod", job_id="payments")
        a.server.state.upsert_deployment(d)
        with pytest.raises(ApiError) as ei:
            dev._request("PUT", "/v1/deployment/fail/dep-prod",
                         params={"namespace": "dev"})
        # denied cross-namespace target reads as missing (no existence
        # oracle), and the deployment was not failed
        assert ei.value.code == 404
        assert a.server.state.deployment_by_id("dep-prod").status \
            == "running"

    def test_rejected_acl_write_does_not_poison_wal(self, tmp_path):
        """A 400-rejected ACL mutation must leave no WAL entry — replay
        after restart must succeed (validate-before-journal)."""
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import ApiError, NomadClient

        data = str(tmp_path / "srv")
        a1 = Agent(AgentConfig(client=False, acl_enabled=True,
                               data_dir=data, heartbeat_ttl=60.0), device="cpu")
        a1.start()
        try:
            anon = NomadClient(*a1.http_addr)
            boot = anon.acl_bootstrap()
            mgmt = NomadClient(a1.http_addr[0], a1.http_addr[1],
                               token=boot.secret_id)
            with pytest.raises(ApiError) as ei:
                mgmt.acl_upsert_policy("bad", "not { hcl")
            assert ei.value.code == 400
            with pytest.raises(ApiError):
                mgmt.acl_create_token(name="t", type="client", policies=[])
        finally:
            a1.shutdown()
        # restart replays the WAL — must come up clean, with no bad policy
        a2 = Agent(AgentConfig(client=False, acl_enabled=True,
                               data_dir=data, heartbeat_ttl=60.0), device="cpu")
        a2.start()
        try:
            mgmt2 = NomadClient(a2.http_addr[0], a2.http_addr[1],
                                token=boot.secret_id)
            assert mgmt2.jobs() == []
            assert all(p.name != "bad" for p in mgmt2.acl_policies())
        finally:
            a2.shutdown()

    def test_wildcard_namespace_lists(self, secure_agent):
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.api import NomadClient

        a, host, port = secure_agent
        boot = NomadClient(host, port).acl_bootstrap()
        mgmt = NomadClient(host, port, token=boot.secret_id)
        j1 = mock.job()
        j2 = mock.job(namespace="prod")
        mgmt.namespace_apply("prod")
        mgmt.register_job(j1)
        mgmt.register_job(j2)
        # management with ?namespace=* sees both; per-ns sees one
        both = mgmt._request("GET", "/v1/jobs", params={"namespace": "*"})
        assert len(both["data"]) == 2
        one = mgmt._request("GET", "/v1/jobs",
                            params={"namespace": "prod"})
        assert len(one["data"]) == 1
        # a default-only token's wildcard list shows only default
        mgmt.acl_upsert_policy(
            "ro-default", 'namespace "default" { policy = "read" }')
        tok = mgmt.acl_create_token(name="d", policies=["ro-default"])
        ro = NomadClient(host, port, token=tok.secret_id)
        mine = ro._request("GET", "/v1/jobs", params={"namespace": "*"})
        assert [j["namespace"] for j in mine["data"]] == ["default"]

    def test_namespace_named_policy_parses(self):
        p = parse_policy('namespace "policy" { policy = "read" }')
        assert p.namespaces[0].name == "policy"
        assert "read-job" in p.namespaces[0].capabilities

    def test_acls_disabled_is_open(self, tmp_path):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import NomadClient

        a = Agent(AgentConfig(client=False, heartbeat_ttl=60.0), device="cpu")
        a.start()
        try:
            api = NomadClient(*a.http_addr)
            assert api.jobs() == []  # no token, no enforcement
        finally:
            a.shutdown()


class TestTokenCacheInvalidation:
    """Token mutations must bump the cache generation so a
    resolve() racing a revocation cannot re-insert the stale compiled ACL
    after the delete popped it (nomad/acl.go cache semantics)."""

    def _store_with_token(self):
        ts = TokenStore()
        ts.upsert_policy(ACLPolicy(
            name="p", rules='namespace "default" { policy = "read" }'))
        tok = ts.upsert_token(ACLToken(name="t", policies=["p"]))
        return ts, tok

    def test_delete_token_bumps_generation(self):
        ts, tok = self._store_with_token()
        gen = ts._cache_gen
        ts.delete_token(tok.accessor_id)
        assert ts._cache_gen > gen
        with pytest.raises(ACLError):
            ts.resolve(tok.secret_id)

    def test_rotation_bumps_generation(self):
        ts, tok = self._store_with_token()
        ts.resolve(tok.secret_id)  # warm the cache
        gen = ts._cache_gen
        rotated = ACLToken(accessor_id=tok.accessor_id, name="t",
                           policies=["p"])
        ts.upsert_token(rotated)
        assert ts._cache_gen > gen
        with pytest.raises(ACLError):
            ts.resolve(tok.secret_id)  # old secret no longer resolves
        ts.resolve(rotated.secret_id)

    def test_racing_resolve_does_not_recache_revoked_token(self):
        ts, tok = self._store_with_token()
        # emulate the race: resolve() captured the token + generation,
        # then the revocation landed before it re-took the lock to cache
        with ts._lock:
            gen = ts._cache_gen
        ts.delete_token(tok.accessor_id)
        acl = ts._compile(tok.policies)
        with ts._lock:
            if ts._cache_gen == gen:  # the guard under test
                ts._acl_cache[tok.secret_id] = acl
        assert tok.secret_id not in ts._acl_cache
