"""Model configs of the port: the reference's dataclasses and the
configurations of the families ported so far (see :mod:`.registry`)."""
