#!/usr/bin/env python3
"""The machine code (SASS) of flightjax_torch's kernels, one digest per
kernel instance, to show that a change of the sources left an instance's
machine code as it was.

    python3 tools/sass_torch_kernels.py --record FILE [--so LIB]
    python3 tools/sass_torch_kernels.py --check FILE [--so LIB]

`--record` writes the digests of a built kernel library (default: the
library `flightjax_torch/parallel/launch.py` builds from the current
sources) with nvcc's version to FILE; `--check` compares the library's
digests with those of FILE and exits 1 if an instance recorded there
differs. A digest covers the instructions of the kernel's `cuobjdump -sass`
section, without addresses and encodings, and the kernel's name without
its template arguments, so an instance that was templated on one more
parameter compares with its form before. An instance that the record does
not hold (a new one) is not compared. `tools/sass_torch_record.json` holds
every instance (the C172S kernels, the fly-by-wire instances, the
C172X megakernels and passes, the mission's, the turbulent C172S's, the
turbulent C172Xv1's and the sensor-fed C172Xv1's instances; the turbulent
and sensor-fed C172Xv2's, the sensor-fed missions' and the turbulent
sensor-fed C172Xv2's and missions' since they were ported), recorded
with the nvcc of an H100 machine; `chip_smoke.py` checks it. A change that means to change the machine code
of a recorded instance records the file anew from its own build
(`--record tools/sass_torch_record.json`). Needs the CUDA toolkit
(`cuobjdump`); the card only to build the default library.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

# a kernel's mangled name: its name, its ActKind (absent before the
# templating, 0 for the C172S, 1 fly-by-wire, 2 turbulent, 3 turbulent
# fly-by-wire), its float type,
# the megakernel's avionics (absent before their templating; 2 the C172Xv2's
# guidance, 3 a mission, 4 the navigation avionics, AV_NAV, 5 the
# navigation avionics around the guidance, AV_GDC_NAV, 6 around a mission,
# AV_MSN_NAV; the sensor-fed missions' msn_ctl_laws and nav_pass instances
# carry the 6 too)
KERNEL = re.compile(r"_Z\d+(\w+?)_kernelI(?:Li(\d)E)?N2fj6StrictI([fd])EE"
                    r"(?:Li(\d)E)?")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def kernel_name(name, act, av):
    """The launch name of a kernel instance from its mangled name's parts:
    `name`, `name_fbw` (the fly-by-wire C172Xv1), `name_gdc` (the C172Xv2),
    `name_msn` (a mission over it), `name_turb` (the turbulent C172S,
    ActKind 2), `name_fbw_turb` (the turbulent C172Xv1, ActKind 3;
    rk4_finish_turb and rk4_finish_fbw_turb are kernels of their own
    names), `name_gdc_turb` and `name_msn_turb` (the turbulent C172Xv2 and
    a mission on it), `name_nav` and `name_nav_turb` (the sensor-fed
    C172Xv1, calm and turbulent, avionics 4), `name_gdc_nav` and
    `name_gdc_nav_turb` (the sensor-fed C172Xv2, calm and turbulent,
    avionics 5), `megakernel_msn_nav`, `megakernel_msn_nav_turb`,
    `msn_nav_ctl_laws` and `nav_pass_msn_nav` (the sensor-fed missions,
    avionics 6)."""
    turb = "_turb" if act == "3" else ""
    if av == "6":
        return ("msn_nav_ctl_laws" if name == "msn_ctl_laws"
                else name + "_msn_nav" + turb)
    if av == "5":
        return name + "_gdc_nav" + turb
    if av == "4":
        return name + ("_nav_turb" if act == "3" else "_nav")
    if av in ("2", "3") and act == "3":
        return name + ("_msn" if av == "3" else "_gdc") + "_turb"
    return name + ("_msn" if av == "3" else "_gdc" if av == "2"
                   else "_fbw_turb" if act == "3"
                   else "_fbw" if act == "1" else "_turb" if act == "2"
                   else "")


def instance(mangled):
    """`name[_fbw|_gdc|_msn]_f32|f64` of a kernel's mangled name, or
    None."""
    m = KERNEL.search(mangled)
    if m is None:
        return None
    name, act, ftype, av = m.groups()
    return kernel_name(name, act, av) + "_" + ("f32" if ftype == "f"
                                               else "f64")


def digests(so, nvcc):
    """{instance: sha256 of its instructions} of the library `so` (a
    section that is no kernel instance under its own name)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         check=True, timeout=600).stdout
    bodies, body = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            body = bodies.setdefault(instance(name) or name, [])
            continue
        m = INSTR.search(line)
        if body is not None and m:
            body.append(re.sub(r"Li\dE", "", m.group(1)))
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()
            for k, v in bodies.items()}


def nvcc_version(nvcc):
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]


def compare(so, record, nvcc):
    """(same, changed, missing) instances of the library `so` against the
    record; raises if the record was made with another nvcc."""
    with open(record) as fh:
        rec = json.load(fh)
    if rec["nvcc"] != nvcc_version(nvcc):
        raise RuntimeError(f"the record is of {rec['nvcc']!r}, this nvcc is "
                           f"{nvcc_version(nvcc)!r}")
    now = digests(so, nvcc)
    same = sorted(k for k, v in rec["sass"].items() if now.get(k) == v)
    changed = sorted(k for k, v in rec["sass"].items()
                     if k in now and now[k] != v)
    missing = sorted(k for k in rec["sass"] if k not in now)
    return same, changed, missing


def main():
    from flightjax_torch.parallel import launch as L
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--record")
    mode.add_argument("--check")
    ap.add_argument("--so", default=None)
    args = ap.parse_args()
    nvcc = L._nvcc()
    so = args.so or L.build()
    if args.record:
        rec = {"nvcc": nvcc_version(nvcc), "sass": digests(so, nvcc)}
        with open(args.record, "w") as fh:
            json.dump(rec, fh, indent=1, sort_keys=True)
        print(f"recorded {len(rec['sass'])} kernel instances of {so}")
        return 0
    same, changed, missing = compare(so, args.check, nvcc)
    print(json.dumps({"same": same, "changed": changed, "missing": missing}))
    return 1 if changed or missing else 0


if __name__ == "__main__":
    sys.exit(main())
