"""The benchmark's frozen input generators: the raycast room, the camera
walks and TUM's ATE arithmetic, copied from the port at commit 6b05da9 so
that later changes to the port cannot move the yardstick."""
