"""TLS material + contexts for the RPC fabric and HTTP API.

Behavioral reference: `helper/tlsutil/config.go` — mutual-TLS contexts
built from ca_file/cert_file/key_file with `verify_incoming` /
`verify_outgoing` semantics (`nomad/rpc.go:225-260` wraps RPC conns the
same way). Includes a miniature CA (the `tlsutil.GenerateCert` test
helpers) so clusters can bootstrap their own material without external
PKI."""
from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from typing import Optional, Tuple


def _write(path: str, data: bytes, mode: int = 0o600) -> str:
    with open(path, "wb") as f:
        f.write(data)
    os.chmod(path, mode)
    return path


def generate_ca(dir_: str, cn: str = "nomad-tpu-ca"
                ) -> Tuple[str, str]:
    """Create a self-signed CA; returns (ca_cert_path, ca_key_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                           critical=True)
            .sign(key, hashes.SHA256()))
    os.makedirs(dir_, exist_ok=True)
    ca_cert = _write(os.path.join(dir_, "ca.pem"),
                     cert.public_bytes(serialization.Encoding.PEM), 0o644)
    ca_key = _write(os.path.join(dir_, "ca-key.pem"), key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    return ca_cert, ca_key


def issue_cert(dir_: str, ca_cert_path: str, ca_key_path: str,
               cn: str, sans: Optional[list] = None,
               name: str = "cert") -> Tuple[str, str]:
    """Issue a server/client cert signed by the CA; returns
    (cert_path, key_path). SANs default to localhost + loopback."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    with open(ca_cert_path, "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    with open(ca_key_path, "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), None)

    key = ec.generate_private_key(ec.SECP256R1())
    alt: list = []
    for s in (sans or ["localhost"]):
        try:
            alt.append(x509.IPAddress(ipaddress.ip_address(s)))
        except ValueError:
            alt.append(x509.DNSName(s))
    alt.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(alt),
                           critical=False)
            .add_extension(x509.ExtendedKeyUsage(
                [ExtendedKeyUsageOID.SERVER_AUTH,
                 ExtendedKeyUsageOID.CLIENT_AUTH]), critical=False)
            .sign(ca_key, hashes.SHA256()))
    cert_path = _write(os.path.join(dir_, f"{name}.pem"),
                       cert.public_bytes(serialization.Encoding.PEM),
                       0o644)
    key_path = _write(os.path.join(dir_, f"{name}-key.pem"),
                      key.private_bytes(
                          serialization.Encoding.PEM,
                          serialization.PrivateFormat.TraditionalOpenSSL,
                          serialization.NoEncryption()))
    return cert_path, key_path


class TLSConfig:
    """Parsed tls{} agent block (helper/tlsutil/config.go TLSConfig)."""

    def __init__(self, enabled: bool = False, ca_file: str = "",
                 cert_file: str = "", key_file: str = "",
                 verify_incoming: bool = False,
                 rpc: bool = False) -> None:
        self.enabled = enabled
        self.ca_file = ca_file
        self.cert_file = cert_file
        self.key_file = key_file
        #: mTLS-verify inbound peers; requires ca_file (defaults False to
        #: match the agent HCL verify_https_client default)
        self.verify_incoming = verify_incoming
        #: enable TLS on the server RPC fabric (consumed by cluster mode:
        #: ClusterServerConfig(tls=...) wraps RpcServer/ConnPool)
        self.rpc = rpc


def server_context(cfg: TLSConfig) -> ssl.SSLContext:
    """Incoming-connection context: serve our cert; mTLS-verify peers
    against the CA when verify_incoming (tlsutil IncomingTLSConfig)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.verify_incoming:
        if not cfg.ca_file:
            raise ValueError("verify_incoming requires ca_file")
        ctx.load_verify_locations(cfg.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(cfg: TLSConfig) -> ssl.SSLContext:
    """Outgoing-connection context: verify the server against the CA and
    present our cert for mTLS (tlsutil OutgoingTLSConfig)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cfg.ca_file)
    if cfg.cert_file:
        ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    ctx.check_hostname = False  # addresses are IPs; CA trust is the gate
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
