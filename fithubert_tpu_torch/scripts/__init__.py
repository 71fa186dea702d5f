"""The consumer end of the port: the downstream probe on an export
(``linear_probe``) and the preemption rehearsal of the whole chain
(``dress_rehearsal``), the counterparts of the repository's ``scripts/``."""
