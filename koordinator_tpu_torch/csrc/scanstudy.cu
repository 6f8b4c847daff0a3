// The scan's study build: scan.cu compiled with its step kernel's phase
// split (SM cycles by phase, read by koord_scan_split) and with pair.cuh's
// exact division held against `/` (koord_div_check), for `chip_smoke.py`.
// No path of the port loads it: cuda.build compiles it only when a study
// binds one of its entry points (cuda.STUDY), and the library the paths
// launch carries none of this.
#define KOORD_SCAN_STUDY
#include "scan.cu"
