"""TLS bootstrap + token-file parsing for the served control plane (port
of tf_operator_tpu/runtime/tlsutil.py).

The reference gets transport security and authentication for free by
riding the Kubernetes API server (every hop is TLS + bearer token + RBAC:
sdk/python/kubeflow/tfjob/api/tf_job_client.py:55-76 loads kube config,
manifests/base/cluster-role.yaml scopes the operator). The TPU-native
served control plane (runtime/apiserver.py) has no API server in front
of it, so it carries its own minimal equivalents:

- a self-signed certificate bootstrap for first-run TLS (private key
  written 0600, never world-readable — the same key-material discipline
  as runtime/kube.py's kubeconfig temp files);
- a static bearer-token file, one token per line with an optional role
  (``admin`` full access, ``read-only`` GET/watch/logs only) — the
  ServiceAccount-token + RBAC-role analog collapsed to two roles.
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import logging
import os
from typing import Dict, Optional, Sequence

log = logging.getLogger("tpu_operator.tls")

ROLE_ADMIN = "admin"
ROLE_READ_ONLY = "read-only"
ROLES = (ROLE_ADMIN, ROLE_READ_ONLY)


def ensure_self_signed(cert_path: str, key_path: str,
                       common_name: str = "tpu-operator",
                       dns_names: Optional[Sequence[str]] = None,
                       ip_addresses: Optional[Sequence[str]] = None,
                       days: int = 3650) -> None:
    """Create a self-signed server certificate + key at the given paths
    if either is missing (idempotent otherwise). SANs default to
    localhost + loopback so local clients verify out of the box; pass
    the operator's service DNS name / host IPs for remote clients."""
    if os.path.exists(cert_path) and os.path.exists(key_path):
        return
    try:
        # Imported lazily: cryptography is an optional extra
        # (``pip install tf-operator-tpu[tls]``) — the operator's
        # token-auth path and every non-TLS deployment must work
        # without it, and only actual cert GENERATION needs it
        # (pre-provisioned cert/key pairs are served by the stdlib).
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        raise RuntimeError(
            "self-signed TLS bootstrap needs the 'cryptography' package; "
            "install the tls extra (pip install tf-operator-tpu[tls]) or "
            "provide --api-tls-cert/--api-tls-key generated elsewhere"
        ) from e

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    sans: list = [x509.DNSName(d) for d in (dns_names or ["localhost"])]
    for ip in (ip_addresses or ["127.0.0.1"]):
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(ip)))
        except ValueError:
            sans.append(x509.DNSName(ip))
    now = _dt.datetime.now(_dt.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _dt.timedelta(minutes=5))
            .not_valid_after(now + _dt.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName(sans),
                           critical=False)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))

    os.makedirs(os.path.dirname(os.path.abspath(key_path)), exist_ok=True)
    # Key first, 0600 from birth (never a window where it's readable).
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    log.info("generated self-signed TLS certificate at %s (CN=%s)",
             cert_path, common_name)


def read_token(path: str) -> str:
    """First token in a token file (clients need exactly one): same
    skipping rules as load_tokens — blank lines and # comments are not
    tokens."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                return line.split()[0]
    raise ValueError(f"{path}: no token found")


def load_tokens(path: str) -> Dict[str, str]:
    """Parse a bearer-token file: one ``<token> [role]`` per line
    (role defaults to admin; blank lines and # comments skipped).
    Returns {token: role}."""
    tokens: Dict[str, str] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            token, role = parts[0], (parts[1] if len(parts) > 1
                                     else ROLE_ADMIN)
            if role not in ROLES:
                raise ValueError(
                    f"{path}:{lineno}: unknown role {role!r} "
                    f"(expected one of {', '.join(ROLES)})")
            if token in tokens:
                raise ValueError(f"{path}:{lineno}: duplicate token")
            tokens[token] = role
    if not tokens:
        raise ValueError(f"{path}: no tokens found")
    return tokens
