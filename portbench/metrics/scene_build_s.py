"""Host seconds of the cell's scene build (``models/*.build`` or
``api.lmp.parse_script(...).build``), read around the call."""


def read(rec):
    return rec.get("scene_build_s")
