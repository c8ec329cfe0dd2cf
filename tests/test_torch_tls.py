"""Twins of the reference's `tests/test_tls.py` `TestHttpsAgent` (the
agent's HTTPS API) and `test_hcl_tls_block` (the agent config's `tls`
block, read by both packages to the same settings), run on the port:
every agent, server and harness is the port's with `device="cpu"`, its
HTTP port ephemeral and its data under `tmp_path`; the reference's
`slow` marks are kept.
"""
import time

import pytest

# the mini-CA is built on pyca/cryptography; containers without the
# package must read these as SKIPPED, not collection errors
pytest.importorskip("cryptography")

from nomad_tpu_torch.lib.tlsutil import (TLSConfig, generate_ca, issue_cert)  # noqa: E402
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=30.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def pki(tmp_path):
    ca_cert, ca_key = generate_ca(str(tmp_path / "pki"))
    srv_cert, srv_key = issue_cert(str(tmp_path / "pki"), ca_cert, ca_key,
                                   "server.global.nomad", name="server")
    cli_cert, cli_key = issue_cert(str(tmp_path / "pki"), ca_cert, ca_key,
                                   "cli.global.nomad", name="cli")
    return {"ca": ca_cert, "ca_key": ca_key,
            "srv_cert": srv_cert, "srv_key": srv_key,
            "cli_cert": cli_cert, "cli_key": cli_key}


class TestHttpsAgent:
    def test_https_api_round_trip(self, tmp_path, pki):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import ApiError, NomadClient

        cfg = AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0,
                          tls=TLSConfig(enabled=True, ca_file=pki["ca"],
                                        cert_file=pki["srv_cert"],
                                        key_file=pki["srv_key"],
                                        verify_incoming=False))
        a = Agent(cfg, device="cpu")
        a.start()
        try:
            api = NomadClient(a.http_addr[0], a.http_addr[1],
                              ca_cert=pki["ca"])
            assert _wait(lambda: len(api.nodes()) == 1)
            assert api.agent_self()

            # plaintext client against the TLS listener must fail
            plain = NomadClient(a.http_addr[0], a.http_addr[1])
            with pytest.raises(Exception):
                plain.nodes()

            # wrong CA must fail verification
            other_ca, _k = generate_ca(str(tmp_path / "pki2"), cn="other")
            bad = NomadClient(a.http_addr[0], a.http_addr[1],
                              ca_cert=other_ca)
            with pytest.raises(Exception):
                bad.nodes()
        finally:
            a.shutdown()

    def test_mtls_http_requires_client_cert(self, tmp_path, pki):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import NomadClient

        cfg = AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0,
                          tls=TLSConfig(enabled=True, ca_file=pki["ca"],
                                        cert_file=pki["srv_cert"],
                                        key_file=pki["srv_key"],
                                        verify_incoming=True))
        a = Agent(cfg, device="cpu")
        a.start()
        try:
            with_cert = NomadClient(a.http_addr[0], a.http_addr[1],
                                    ca_cert=pki["ca"],
                                    client_cert=pki["cli_cert"],
                                    client_key=pki["cli_key"])
            assert with_cert.agent_self()
            without = NomadClient(a.http_addr[0], a.http_addr[1],
                                  ca_cert=pki["ca"])
            with pytest.raises(Exception):
                without.agent_self()
        finally:
            a.shutdown()




class TestHclTls:
    def test_hcl_tls_block(self, pki):
        from nomad_tpu.agent import AgentConfig as RefConfig

        from nomad_tpu_torch.agent import AgentConfig

        hcl = f'''
        client {{ enabled = true }}
        tls {{
          http = true
          ca_file = "{pki['ca']}"
          cert_file = "{pki['srv_cert']}"
          key_file = "{pki['srv_key']}"
          verify_https_client = false
        }}
        '''
        cfg = AgentConfig.from_hcl(hcl)
        assert cfg.tls is not None and cfg.tls.enabled
        assert cfg.tls.ca_file == pki["ca"]
        assert cfg.tls.verify_incoming is False
        assert vars(cfg.tls) == vars(RefConfig.from_hcl(hcl).tls)
