"""The port's deploy-time checks (dora_tpu/analysis/__init__.py's
:class:`Finding` shape): so far the alert-rule lint, ``alertcheck``, which
``python -m dora_tpu_torch.cli check`` runs."""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class Finding:
    """One diagnostic of a check: ``code`` is stable and machine-matchable,
    ``level`` is ``error`` or ``warning``, ``where`` names what it is
    about (a rule, an environment variable)."""

    pass_name: str
    code: str
    level: str
    where: str
    message: str
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        return f"[{self.pass_name}] {self.level} {self.code} {self.where}: {self.message}"


def errors(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.level == "error"]
