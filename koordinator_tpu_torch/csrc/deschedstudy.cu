// The round's study build: deschedule.cu compiled with its split (the SM
// clock of block 0 after each grid barrier, and of the side blocks when
// they end; read by koord_desched_split), for `chip_smoke.py --desched`.
// No path of the port loads it: cuda.build compiles it only when a study
// binds one of its entry points (cuda.STUDY), and the library the paths
// launch carries none of this.
#define KOORD_DESCHED_STUDY
#include "deschedule.cu"
